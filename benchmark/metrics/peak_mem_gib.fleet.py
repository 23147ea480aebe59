"""The allocator's peak over set-up and window
(torch.cuda.max_memory_allocated), in GiB."""


def read(ctx):
    return ctx.memory_peak / 2 ** 30 if ctx.memory_peak else None
