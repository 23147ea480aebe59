"""Median device time of the frontend's nlm stage a frame: CUDA events
around the package's stage call, over the frames before the profiler starts."""

import statistics


def read(ctx):
    ms = ctx.spans.ms("nlm")
    return statistics.median(ms) if ms else None
