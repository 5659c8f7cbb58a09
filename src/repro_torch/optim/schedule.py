"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak``.

    ``lr(step)`` is an f32 tensor on the step's device, computed as the
    reference computes it (f32 ``cos``, ``pi``, clip and select), so its
    rounding over a run matches the reference's and reading it never syncs
    the host."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak * step / max(warmup, 1)
        progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * progress))
        return torch.where(step < warmup, warm, cos)

    return lr
