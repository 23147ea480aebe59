"""Device time a batched iteration outside every mapped kernel: the scalar
glue (packing, step size, exp, pose update, indicator, drift bound) and
the build's torch part, in the profiled sub-window."""


def read(ctx):
    n = ctx.trace.units
    if not n or not ctx.trace.events:
        return None
    return ctx.unmapped_time_us() / n / 1e3
