"""Median device time of the frontend's select stage a frame: CUDA events
around the package's stage call, over the frames before the profiler starts."""

import statistics


def read(ctx):
    ms = ctx.spans.ms("select")
    return statistics.median(ms) if ms else None
