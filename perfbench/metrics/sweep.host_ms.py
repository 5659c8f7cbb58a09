"""Host milliseconds per sweep in ``repro_torch.sweep`` less its ``.wait``
child: enqueuing the sweep's launches and the host's work between them
(``sweep_cost``, the frontier arithmetic), traced window, mean over
sweeps."""
from perfbench import spans


def read(ctx):
    return spans.ms_per_sweep(ctx, (spans.SWEEP,), less=(spans.WAIT,))
