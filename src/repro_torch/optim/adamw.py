"""AdamW with decoupled weight decay."""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, f32_buffer, step_f32


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """The reference's AdamW, leaf by leaf: ``m`` and ``v`` in f32, updated
    in place; the bias corrections ``1 - b**step`` in f32. Each leaf's update
    ``-lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p)`` is written into
    its gradient's storage where that is f32 (:func:`f32_buffer`)."""

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        step_f = step_f32(step)
        lr = lr_fn(step_f)
        bc1 = 1.0 - b1 ** step_f
        bc2 = 1.0 - b2 ** step_f
        updates = {}
        for k, g in grads.items():
            m, v, p = state["m"][k], state["v"][k], params[k]
            g32 = g.float()
            m.mul_(b1).add_(g32 * (1 - b1))
            v.mul_(b2).add_(g32 * (1 - b2) * g32)
            denom = torch.sqrt(v / bc2).add_(eps)
            u = torch.div(m, bc1, out=f32_buffer(g)).div_(denom)
            u.add_(p.float() * weight_decay).mul_(-lr)
            updates[k] = u
        return updates, state

    return Optimizer(init=init, update=update)
