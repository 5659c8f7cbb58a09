"""Optimizer interface and gradient utilities, as the JAX package's
``optim/base.py`` defines them, on dicts of tensors.

A parameter set is a dict of tensors (a model's ``named_parameters``, or any
keys). The port updates in place where the reference returns new arrays:
``update`` writes the updates into the gradients' storage where that is f32
and changes the state's tensors, and :func:`apply_updates` adds them to the
parameters, so a step holds no second full copy of parameters or gradients.
Norms reduce in f32 on the tensors' device, with no sync to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Pair of plain functions (optax-style, dependency-free)."""

    init: Callable[[Any], Any]  # params -> state
    update: Callable[..., Any]  # (grads, state, params, step) -> (updates, state)


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in iteration order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def step_f32(step) -> torch.Tensor:
    """``step + 1`` in f32, on the step's device: the count the schedules
    and bias corrections read."""
    return torch.as_tensor(step).to(torch.float32) + 1.0


def f32_buffer(g: torch.Tensor) -> torch.Tensor:
    """Where a leaf's f32 update goes: the gradient's own storage when it is
    f32 (the optimizer consumes it), else a new f32 tensor."""
    return g if g.dtype == torch.float32 else torch.empty(g.shape, device=g.device)


@torch.no_grad()
def apply_updates(params, updates):
    """``p += u`` for every leaf, in place. The sum is taken in f32 and cast
    once to the parameter's dtype, as the reference's
    ``(p + u).astype(p.dtype)``. Returns ``params``."""
    for k, p in params.items():
        p.add_(updates[k])
    return params


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """The f32 2-norm of every leaf together (a 0-d tensor on their device)."""
    norms = torch._foreach_norm(list(tree_leaves(tree)), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so that their global norm is at most
    ``max_norm``; returns ``(grads, norm before clipping)``."""
    norm = global_norm(grads)
    scale = torch.clamp_max(norm.new_tensor(max_norm) / torch.clamp_min(norm, 1e-9), 1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm
