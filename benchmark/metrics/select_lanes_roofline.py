"""The lanes' list builds in the profiled sub-window: the least time the
chip needs for the bytes and operations of the lanes that were built
(work/select_lanes.py) over the device time of the kernels mapped to the
layer `select_lanes` (kernels/), in percent."""


def read(ctx):
    t = ctx.layer_time_us("select_lanes")
    lanes = ctx.counters["trace_lanes_built"]
    if not t or not lanes:
        return None
    c = ctx.counters
    nbytes, ops = ctx.work("select_lanes").work(c["points"], c["points"], c["K"], lanes)
    least = max(nbytes / ctx.peaks["hbm_bytes_per_s"], ops / ctx.peaks["f32_flops"])
    return 100.0 * least / (t * 1e-6)
