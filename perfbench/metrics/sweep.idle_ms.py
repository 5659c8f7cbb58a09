"""Device-idle milliseconds per sweep that fall inside ``repro_torch.sweep``
spans (their ``.launch`` and ``.wait`` children included): the launch gaps
of the sweep loop, traced window, mean over sweeps."""
from perfbench import spans


def read(ctx):
    return spans.idle_ms_per_sweep(ctx)
