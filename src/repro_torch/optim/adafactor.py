"""Adafactor (Shazeer & Stern 2018): factored second moments, no momentum.

For a [r, c] parameter the second-moment estimate is stored as a rank-1
factorization (row + col running means): O(r + c) optimizer state instead
of O(r c). 1-D parameters fall back to the full second moment.

The reference runs it on its own parameter tree, where every scanned layer
slot is one ``[n_groups, ...]`` leaf, and three of its quantities are taken
over the whole leaf: whether it is factored (``ndim >= 2``), the
update-clipping RMS and the relative-step scale ``rms(p)``. The port keeps
one tensor per layer, so it takes the reference's leaves as ``leaves`` (each
a ``path``, the port ``keys`` of its slices and whether it is ``stacked``;
:func:`repro_torch.models.convert.reference_leaves`): per leaf it stacks the
slices' gradients and parameters, updates, and writes the slices back, one
leaf's temporaries at a time. The state is the reference's tree, stacked
(``vr``, ``vc`` or ``v`` with the leading ``[n_groups]`` axis).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.models.convert import RefLeaf
from repro_torch.optim.base import Optimizer, step_f32


def _own_leaves(params):
    return [RefLeaf((k,), (k,), False) for k in params]


def _gather(tensors, leaf) -> torch.Tensor:
    if leaf.stacked:
        return torch.stack([tensors[k] for k in leaf.keys])
    return tensors[leaf.keys[0]]


def _keep_layout(new, old):
    """On a mesh, the state ``new`` laid out as the state ``old`` it
    replaces; otherwise ``new`` as it is."""
    if not hasattr(old, "placements") or tuple(new.placements) == tuple(old.placements):
        return new
    return new.redistribute(old.device_mesh, old.placements)


def _factor_like(f, g, dim: int):
    """On a mesh, ``f`` (``g`` reduced over ``dim``) laid out as ``g`` is on
    its other dims, so that its product with the other factor is formed on
    ``g``'s shards (each rank slices the factors; the ``[..., r, c]``
    preconditioner is never whole on a rank). Otherwise ``f`` as it is."""
    if not hasattr(f, "placements"):
        return f
    from torch.distributed.tensor import Replicate, Shard

    target = tuple(Shard(pl.dim - (pl.dim > dim)) if pl.is_shard() and pl.dim != dim
                   else Replicate() for pl in g.placements)
    return f if tuple(f.placements) == target else f.redistribute(f.device_mesh, target)


def _node(tree: dict, path, create: bool = False) -> dict:
    for key in path:
        tree = tree.setdefault(key, {}) if create else tree[key]
    return tree


def adafactor(lr_fn, decay: float = 0.8, eps1: float = 1e-30, eps2: float = 1e-3,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              leaves: Sequence = None) -> Optimizer:
    """``leaves``: the reference's leaves over the parameter dict's keys;
    ``None`` makes every key a leaf of its own (path ``(key,)``)."""

    def _leaves(params):
        return leaves if leaves is not None else _own_leaves(params)

    def init(params):
        state: dict = {}
        for leaf in _leaves(params):
            p = params[leaf.keys[0]]
            shape = ((len(leaf.keys),) if leaf.stacked else ()) + tuple(p.shape)
            if len(shape) >= 2:
                s = {"vr": torch.zeros(shape[:-1], device=p.device),
                     "vc": torch.zeros(shape[:-2] + shape[-1:], device=p.device)}
            else:
                s = {"v": torch.zeros(shape, device=p.device)}
            _node(state, leaf.path, create=True).update(s)
        return state

    @torch.no_grad()
    def update(grads, state, params, step):
        step_f = step_f32(step)
        lr = lr_fn(step_f)
        beta = 1.0 - step_f ** (-decay)
        updates = {}
        for leaf in _leaves(params):
            g = _gather(grads, leaf).float()
            s = _node(state, leaf.path)
            g2 = g * g + eps1
            if g.ndim >= 2:
                s["vr"] = _keep_layout(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1), s["vr"])
                s["vc"] = _keep_layout(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2), s["vc"])
                denom = torch.clamp_min(s["vr"].mean(dim=-1, keepdim=True), eps1)
                row = _factor_like(s["vr"] / denom, g, g.ndim - 1)
                col = _factor_like(s["vc"], g, g.ndim - 2)
                u = g * torch.rsqrt(row[..., None] * col[..., None, :] + eps1)
            else:
                s["v"] = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(s["v"] + eps1)
            del g, g2
            # Update clipping (RMS <= clip_threshold).
            rms = torch.sqrt(torch.mean(u * u) + eps1)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            p = _gather(params, leaf).float()
            scale = torch.clamp_min(torch.sqrt(torch.mean(p ** 2)), eps2)  # relative step
            out = -lr * scale * u
            if weight_decay:
                out = out - lr * weight_decay * p
            del p, u
            for i, k in enumerate(leaf.keys):
                piece = out[i] if leaf.stacked else out
                if grads[k].dtype == torch.float32:
                    updates[k] = grads[k].copy_(piece)
                else:
                    updates[k] = piece
        return updates, state

    return Optimizer(init=init, update=update)
