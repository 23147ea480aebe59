"""Share of a step's wall time in which no operation ran on the device, in
percent: 1 - (device busy a unit in the profiled sub-window) / (wall a unit
over the window's steps before the profiler started). The profiler's own
cost on every launch stays out of the wall time."""


def read(ctx):
    c = ctx.counters
    if not ctx.trace.events or not ctx.trace.units or not c["clean_units"]:
        return None
    busy = ctx.trace.busy_us() * 1e-6 / ctx.trace.units
    return 100.0 * (1.0 - busy / (c["clean_s"] / c["clean_units"]))
