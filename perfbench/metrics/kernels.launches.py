"""Launches of the fused sweep kernel per decomposition: the difference of
``fused_sweep_op.launches`` (``kernels/plan.py`` ``count_launch``) over the
traced window, over the decompositions of the window."""


def read(ctx):
    counters = getattr(ctx, "counters", None)
    if not counters or not counters.get("launches") or not ctx.results:
        return None
    return counters["launches"] / len(ctx.results)
