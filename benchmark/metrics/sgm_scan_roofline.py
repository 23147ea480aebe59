"""The SGM path recurrences of the profiled frames: the least time for the
bytes the three 3WAY paths need (work/sgm_scan.py) over the device time of
the kernels mapped to the layer `sgm_scan`, in percent."""


def read(ctx):
    t = ctx.layer_time_us("sgm_scan")
    n = ctx.trace.units
    if not t or not n:
        return None
    c = ctx.config
    nbytes, ops = ctx.work("sgm_scan").work(c["rows"], c["cols"], c["max_disparity"])
    least = n * max(nbytes / ctx.peaks["hbm_bytes_per_s"], ops / ctx.peaks["f32_flops"])
    return 100.0 * least / (t * 1e-6)
