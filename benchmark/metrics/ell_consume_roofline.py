"""The flow and step passes of every lane over the profiled batched
iterations: the least time for their bytes and operations
(work/ell_consume.py) over the device time of the kernels mapped to the
layer `ell_consume`, in percent."""


def read(ctx):
    t = ctx.layer_time_us("ell_consume")
    n = ctx.trace.units
    if not t or not n:
        return None
    c = ctx.counters
    nbytes, ops = ctx.work("ell_consume").work(c["points"], c["K"], c["lanes"])
    least = n * max(nbytes / ctx.peaks["hbm_bytes_per_s"], ops / ctx.peaks["f32_flops"])
    return 100.0 * least / (t * 1e-6)
