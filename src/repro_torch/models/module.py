"""Spec-first parameters, as the JAX package's ``models/module.py`` declares
them.

Every layer declares its parameters as a dict of :class:`ParamSpec` (shape,
logical axis names, initializer, dtype). :class:`SpecModule` turns such a
dict into an ``nn.Module`` whose parameter and child names are the dict's
keys, so a ``state_dict`` key spells the reference tree's path.
:func:`init_params` draws every parameter from one ``torch.Generator``.

The logical axes are metadata here: on one card nothing is sharded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = never sharded)
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: float = 1.0
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes/shape rank mismatch: {self.shape} vs {self.axes}")


def _fan_in(shape: Tuple[int, ...]) -> int:
    return shape[0] if len(shape) >= 2 else max(shape[-1], 1)


@torch.no_grad()
def init_leaf_(t: torch.Tensor, spec: ParamSpec, generator: torch.Generator) -> None:
    """Draw ``t`` in place by ``spec.init``. The draws are made in f32 and
    cast to the parameter's dtype, as the reference casts its draws."""
    if spec.init == "zeros":
        t.zero_()
        return
    if spec.init == "ones":
        t.fill_(1)
        return
    x = t if t.dtype == torch.float32 else torch.empty(t.shape, device=t.device)
    if spec.init == "embed":
        x.normal_(generator=generator).mul_(spec.scale)
    elif spec.init == "small":
        x.normal_(generator=generator).mul_(0.02 * spec.scale)
    else:
        # Truncated normal at +-2 of a unit normal, scaled by the fan-in std:
        # the bounds are +-2 std.
        std = spec.scale / math.sqrt(max(_fan_in(spec.shape), 1))
        nn.init.trunc_normal_(x, a=-2.0, b=2.0, generator=generator).mul_(std)
    if x is not t:
        t.copy_(x)


class SpecModule(nn.Module):
    """A module whose parameters come from a spec dict.

    A :class:`ParamSpec` value becomes a parameter of its shape and dtype
    (uninitialized until :func:`init_params`, and never trained:
    ``requires_grad=False``), a dict becomes a child ``SpecModule``, and an
    ``nn.Module`` is added as a child as it is.
    """

    def __init__(self, specs: dict, device=None):
        super().__init__()
        self.param_specs = {}
        for name, spec in specs.items():
            if isinstance(spec, ParamSpec):
                data = torch.empty(spec.shape, dtype=spec.dtype, device=device)
                self.register_parameter(name, nn.Parameter(data, requires_grad=False))
                self.param_specs[name] = spec
            elif isinstance(spec, nn.Module):
                self.add_module(name, spec)
            else:
                self.add_module(name, SpecModule(spec, device))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of ``model`` from one generator seeded ``seed``,
    on the parameters' device, in module order. Returns ``model``."""
    params = list(model.parameters())
    if not params or params[0].device.type == "meta":
        return model
    generator = torch.Generator(device=params[0].device).manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, SpecModule):
            for name, spec in mod.param_specs.items():
                init_leaf_(getattr(mod, name), spec, generator)
    return model


def count_params(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))
