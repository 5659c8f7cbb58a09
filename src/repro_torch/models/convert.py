"""Carry the JAX package's parameters into the port's model.

The reference keeps its parameters as a nested dict whose stacked layers
have a leading ``[n_groups]`` axis (``stack/scan/slot{i}/...``) and an
unrolled tail (``stack/tail/layer{i}/...``). :func:`from_reference` unstacks
them into the port's one-block-per-layer ``state_dict`` keys
(``layers.{g * period + i}...``).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

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


def from_reference(cfg, params) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for the JAX package's parameter tree.

    ``params`` is ``init_params(build_specs(cfg), key)`` of the reference
    with numpy leaves (``np.asarray``), or torch tensors of the same shapes
    (``meta`` ones map shapes without memory). A leaf that maps to no
    parameter, a parameter that no leaf fills, or a shape or dtype that
    differs from the port's is an error. The values are views of the leaves
    where possible; ``load_state_dict`` copies them.
    """
    expected = {k: (tuple(v.shape), v.dtype)
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
