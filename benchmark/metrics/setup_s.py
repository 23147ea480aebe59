"""Seconds from the process's start to the end of the warm pass: imports,
inputs made from the seed, kernels loaded (built on a checkout's first
run), the warm pass of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
