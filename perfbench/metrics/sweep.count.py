"""Sweeps per decomposition (``DecomposeResult.iterations``), mean over
the traced window: the sweep loop's work count in ``core/decompose.py``."""


def read(ctx):
    if not ctx.results:
        return None
    return sum(r.iterations for r in ctx.results) / len(ctx.results)
