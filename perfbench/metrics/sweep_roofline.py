"""One full sweep's share of its roofline, in percent: the least bytes a
full sweep of this graph must move (``perfbench/roofline.py``, counted by
the runner as ``sweep_least_bytes``) at the published HBM bandwidth, over
the device time of the kernels of the runner's ``sweep_once`` (one
``decompose(..., max_iter=1)`` from the start state), profiled alone after
the window."""

from perfbench import roofline


def read(ctx):
    least = ctx.facts.get("sweep_least_bytes")
    if not ctx.sweep_kernel_s or not least:
        return None
    return roofline.share_percent(least, ctx.sweep_kernel_s)
