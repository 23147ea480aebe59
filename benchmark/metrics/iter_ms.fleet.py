"""Host wall time a batched iteration: the frames run before the profiler
started, over the batched iterations the solve loop ran in them (its own
count, one flag read a batched iteration)."""


def read(ctx):
    c = ctx.counters
    return c["clean_s"] * 1e3 / c["clean_units"] if c["clean_units"] else None
