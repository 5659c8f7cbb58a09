"""``torch.cuda.max_memory_allocated()`` over the window (the counter is
reset at the end of set-up), in units of 10**9 bytes."""


def read(ctx):
    if ctx.peak_bytes <= 0:
        return None
    return ctx.peak_bytes / 1e9
