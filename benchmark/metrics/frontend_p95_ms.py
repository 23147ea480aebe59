"""The 95th percentile of every frame's latency in the window, each frame
timed from its call to the synchronised end of its cloud."""

import harness


def read(ctx):
    return harness.percentile([r["latency_s"] * 1e3 for r in ctx.records], 95)
