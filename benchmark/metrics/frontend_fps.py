"""Clouds made over the whole window."""

import harness


def read(ctx):
    return harness.rate(ctx)
