"""Registered pairs over the whole window (all drives, all frames)."""

import harness


def read(ctx):
    return harness.rate(ctx)
