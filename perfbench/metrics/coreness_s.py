"""Seconds of the window over the calls it completed (each a
decomposition that ended in a synchronize); host clock."""


def read(ctx):
    if not ctx.results:
        return None
    return ctx.window_s / len(ctx.results)
