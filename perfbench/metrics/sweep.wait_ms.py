"""Host milliseconds per sweep in ``repro_torch.sweep.wait``: the sweep's
one read of the changed counts and dirty flags, which waits for the device
to finish the sweep, traced window, mean over sweeps."""
from perfbench import spans


def read(ctx):
    return spans.ms_per_sweep(ctx, (spans.WAIT,))
