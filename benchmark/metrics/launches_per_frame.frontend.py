"""Device kernels, copies and fills a frame in the profiled frames."""


def read(ctx):
    n = ctx.trace.units
    return len(ctx.trace.events) / n if n and ctx.trace.events else None
