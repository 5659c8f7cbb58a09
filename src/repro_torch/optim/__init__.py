"""Optimizers (no optax dependency): AdamW and Adafactor, as the JAX
package's ``optim/`` computes them, on dicts of tensors updated in place.
``get_optimizer`` dispatches on the arch config; Adafactor gets the
reference's stacked leaves of the model (``models/convert.py``)."""
from repro_torch.models.convert import reference_leaves
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import Optimizer, apply_updates, clip_by_global_norm, global_norm
from repro_torch.optim.schedule import warmup_cosine


def get_optimizer(cfg, lr: float = 3e-4, warmup: int = 100, total: int = 10_000):
    sched = warmup_cosine(lr, warmup, total)
    if cfg.optimizer == "adafactor":
        return adafactor(sched, leaves=reference_leaves(cfg))
    return adamw(sched)


__all__ = [
    "adamw",
    "adafactor",
    "warmup_cosine",
    "Optimizer",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
    "get_optimizer",
]
