"""Carry the JAX package's parameters into the port's model.

The reference keeps its parameters as a nested dict whose stacked layers
have a leading ``[n_groups]`` axis (``stack/scan/slot{i}/...``) and an
unrolled tail (``stack/tail/layer{i}/...``). :func:`from_reference` unstacks
them into the port's one-block-per-layer ``state_dict`` keys
(``layers.{g * period + i}...``); :func:`to_reference` restacks them (the
checkpoints of training are in the reference's layout), and
:func:`reference_leaves` lists every reference leaf with the port keys of its
slices (Adafactor takes its statistics over those leaves).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.blocks import stack_layout
from repro_torch.models.model import CausalLM


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (key,))
    else:
        yield path, tree


def _tensor(leaf) -> torch.Tensor:
    """A torch view of a leaf: a tensor as it is (``meta`` ones too), a numpy
    array (``bfloat16`` ones through their 16-bit pattern) as a CPU tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _unstack(cfg, stack_path: Tuple[str, ...], rest: Tuple[str, ...], t, n_layers,
             causal: bool, allow_cross: bool):
    """(key, tensor) pairs of one leaf under a reference ``stack``."""
    period, n_groups, _kinds, _tail = stack_layout(cfg, n_layers, causal, allow_cross)
    prefix = ".".join(stack_path[:-1] + ("layers",))
    where, slot, leaf = rest[0], rest[1], ".".join(rest[2:])
    if where == "scan" and slot.startswith("slot"):
        if t.ndim == 0 or t.shape[0] != n_groups:
            raise ValueError(f"{'/'.join(stack_path + rest)}: leading dim "
                             f"{tuple(t.shape)[:1]} is not the {n_groups} scan groups")
        i = int(slot[len("slot"):])
        return [(f"{prefix}.{g * period + i}.{leaf}", t[g]) for g in range(n_groups)]
    if where == "tail" and slot.startswith("layer"):
        i = int(slot[len("layer"):])
        return [(f"{prefix}.{n_groups * period + i}.{leaf}", t)]
    raise KeyError(f"{'/'.join(stack_path + rest)}: not a scan slot or tail layer")


def from_reference(cfg, params, dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for the JAX package's parameter tree.

    ``params`` is ``init_params(build_specs(cfg), key)`` of the reference
    with numpy leaves (``np.asarray``), or torch tensors of the same shapes
    (``meta`` ones map shapes without memory). A leaf that maps to no
    parameter, a parameter that no leaf fills, or a shape or dtype that
    differs from the port's is an error. The values are views of the leaves
    where possible; ``load_state_dict`` copies them. ``dtype``: the dtype
    every leaf must have in place of the parameters' own (an optimizer's
    f32 moments over the tree).
    """
    expected = {k: (tuple(v.shape), dtype or v.dtype)
                for k, v in CausalLM(cfg, device="meta").state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        t = _tensor(leaf)
        if path[0] == "stack":
            pairs = _unstack(cfg, path[:1], path[1:], t, None, True, True)
        elif path[:2] == ("encoder", "stack"):
            pairs = _unstack(cfg, path[:2], path[2:], t, cfg.encoder.n_layers, False, False)
        else:
            pairs = [(".".join(path), t)]
        for key, val in pairs:
            if key not in expected:
                raise KeyError(f"reference leaf {'/'.join(path)} maps to {key}, which the "
                               f"port's model does not have")
            if key in out:
                raise KeyError(f"{key} is filled twice")
            shape, dtype = expected[key]
            if tuple(val.shape) != shape or val.dtype != dtype:
                raise ValueError(f"reference leaf {'/'.join(path)} -> {key}: "
                                 f"{tuple(val.shape)} {val.dtype}, the port has {shape} {dtype}")
            out[key] = val
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"no reference leaf for {len(missing)} parameter(s): {missing[:8]}")
    return out


class RefLeaf(NamedTuple):
    """One leaf of the reference's parameter tree."""

    path: Tuple[str, ...]  # its path in the reference's tree
    keys: Tuple[str, ...]  # the port's state_dict keys of its slices
    stacked: bool  # a scan leaf: keys[g] is slice [g] of its [n_groups, ...]


def _reference_path(cfg, key: str) -> Tuple[Tuple[str, ...], int, bool]:
    """(reference path, group, stacked) of one port ``state_dict`` key."""
    parts = tuple(key.split("."))
    if parts[0] == "layers":
        head, layout = ("stack",), stack_layout(cfg)
    elif parts[:2] == ("encoder", "layers"):
        head, layout = ("encoder", "stack"), stack_layout(cfg, cfg.encoder.n_layers, False, False)
        parts = parts[1:]
    else:
        return parts, 0, False
    period, n_groups = layout[0], layout[1]
    layer, rest = int(parts[1]), parts[2:]
    if layer < n_groups * period:
        g, i = divmod(layer, period)
        return head + ("scan", f"slot{i}") + rest, g, True
    return head + ("tail", f"layer{layer - n_groups * period}") + rest, 0, False


def reference_leaves(cfg) -> List[RefLeaf]:
    """Every leaf of the reference's parameter tree for ``cfg``, in its
    flattening order (sorted paths), with the port keys of its slices in
    group order."""
    slices: Dict[Tuple[str, ...], list] = {}
    stacked: Dict[Tuple[str, ...], bool] = {}
    for key in CausalLM(cfg, device="meta").state_dict():
        path, g, is_stacked = _reference_path(cfg, key)
        slices.setdefault(path, []).append((g, key))
        stacked[path] = is_stacked
    return [RefLeaf(path, tuple(k for _g, k in sorted(slices[path])), stacked[path])
            for path in sorted(slices)]


def _host(t: torch.Tensor):
    """A host copy of ``t``: a numpy array, except that a bf16 tensor stays a
    CPU tensor (numpy has no bf16) and a meta tensor stays meta."""
    t = t.detach()
    if t.device.type == "meta":
        return t
    t = t.to("cpu", copy=True)
    return t if t.dtype == torch.bfloat16 else t.numpy()


def to_reference(cfg, state_dict) -> dict:
    """The reference's parameter tree for the port's ``state_dict`` (or any
    dict of tensors over its keys): scan slices restacked into ``[n_groups,
    ...]`` leaves, host copies (:func:`_host`). The inverse of
    :func:`from_reference`."""
    tree: dict = {}
    for leaf in reference_leaves(cfg):
        parts = [state_dict[k] for k in leaf.keys]
        t = torch.stack(parts) if leaf.stacked else parts[0]
        node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = _host(t)
    return tree
