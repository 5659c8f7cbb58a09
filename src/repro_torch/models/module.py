"""Spec-first parameters, as the JAX package's ``models/module.py`` declares
them.

Every layer declares its parameters as a dict of :class:`ParamSpec` (shape,
logical axis names, initializer, dtype). :class:`SpecModule` turns such a
dict into an ``nn.Module`` whose parameter and child names are the dict's
keys, so a ``state_dict`` key spells the reference tree's path.
:func:`init_params` draws every parameter from one ``torch.Generator``.

On one card the logical axes are metadata. The dry-run resolves them on a
mesh (:mod:`repro_torch.sharding.policy`): :func:`param_shardings` gives
each parameter its spec and :func:`abstract_params` swaps a meta model's
parameters for meta DTensors with those placements, so the model runs
unchanged on a mesh without allocating anything.
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


def param_specs(model: nn.Module) -> dict:
    """``{state_dict key: ParamSpec}`` of every parameter of ``model``."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, SpecModule):
            for pname, spec in mod.param_specs.items():
                out[f"{name}.{pname}" if name else pname] = spec
    return out


def _specs_of(model_or_specs) -> dict:
    if isinstance(model_or_specs, nn.Module):
        return param_specs(model_or_specs)
    return model_or_specs


def _resolution_order(specs: dict, cfg):
    """``(shape, axes, keys, stacked)`` of each resolution, in the reference's order.

    With a model's ``cfg`` (:class:`~repro_torch.models.model.CausalLM`) one
    per leaf of the reference's tree, sorted by path, a scanned slot
    resolved once on its ``[n_groups, ...]`` shape with the leading axis
    ``"layers"`` (so a :class:`ResolveLog` equals the reference's); without
    one, one per key."""
    if cfg is None:
        return [(s.shape, s.axes, (k,), False) for k, s in specs.items()]
    from repro_torch.models.convert import reference_leaves

    out = []
    for leaf in reference_leaves(cfg):
        s = specs[leaf.keys[0]]
        if leaf.stacked:
            out.append(((len(leaf.keys),) + s.shape, ("layers",) + s.axes, leaf.keys, True))
        else:
            out.append((s.shape, s.axes, leaf.keys, False))
    return out


def param_shardings(model_or_specs, mesh, rules=None, log=None) -> dict:
    """``{key: Spec}`` from the parameters' logical axes via the sharding
    policy (``model_or_specs``: a model, or a dict of :class:`ParamSpec`).
    A scanned leaf's spec is resolved once and its leading (layers) entry
    dropped for each layer's parameter."""
    from repro_torch.sharding.policy import Spec, resolve

    specs = _specs_of(model_or_specs)
    out = {}
    for shape, axes, keys, stacked in _resolution_order(specs, getattr(model_or_specs, "cfg",
                                                                       None)):
        spec = resolve(shape, axes, mesh, rules, log)
        if stacked:
            spec = Spec(*spec[1:])
        for k in keys:
            out[k] = spec
    return {k: out[k] for k in specs}


def dtensor_of(local, shape, mesh, spec):
    """A DTensor of global ``shape`` on ``mesh``, laid out by ``spec``, whose
    shard on this rank is ``local``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.policy import placements

    shape = tuple(shape)
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def meta_dtensor(shape, dtype, mesh, spec):
    """A DTensor of global ``shape`` and ``dtype`` on ``mesh``, laid out by
    ``spec``, whose local shard is a meta tensor (nothing allocated)."""
    from repro_torch.sharding.policy import local_shape

    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype, device="meta")
    return dtensor_of(local, shape, mesh, spec)


def abstract_params(model_or_specs, mesh=None, rules=None, log=None) -> dict:
    """Dry-run parameters: ``{key: tensor}`` of meta tensors of the specs'
    shapes and dtypes, or, with a ``mesh`` (a ``DeviceMesh``), meta DTensors
    with the resolved placements. Given a model (built on ``meta``), its
    ``nn.Parameter``s are swapped in place for them, so the model runs on
    them unchanged."""
    specs = _specs_of(model_or_specs)
    if mesh is None:
        out = {k: torch.empty(s.shape, dtype=s.dtype, device="meta") for k, s in specs.items()}
    else:
        shardings = param_shardings(model_or_specs, mesh, rules, log)
        out = {k: meta_dtensor(s.shape, s.dtype, mesh, shardings[k]) for k, s in specs.items()}
    if isinstance(model_or_specs, nn.Module):
        for key, t in out.items():
            owner, _, name = key.rpartition(".")
            mod = model_or_specs.get_submodule(owner) if owner else model_or_specs
            mod._parameters[name] = nn.Parameter(t, requires_grad=False)
        out = dict(model_or_specs.named_parameters())
    return out


def count_params(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))
