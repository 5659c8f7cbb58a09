"""Dry-run input specs: meta DTensor stand-ins for every input of a step,
the port of ``repro.launch.specs``.

Everything here is metadata: the tensors are meta tensors (the local shard
of rank 0) inside DTensors on a ``DeviceMesh``, so the 314B/398B configs
cost nothing to describe. Sharding resolution goes through
:mod:`repro_torch.sharding.policy` with per-arch/per-shape rule variants
(long-context decode shards the cache sequence dim over "data").

The port keeps one block, and one cache, per layer: where the reference
stacks a scanned slot's leaves ``[n_groups, ...]``, each layer here holds
one slice, with the reference's spec less its leading (unsharded) entry.
Each stacked leaf is resolved once, in the reference's tree order, so the
:class:`~repro_torch.sharding.policy.ResolveLog` equals the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models import blocks
from repro_torch.models.model import CausalLM
from repro_torch.models.module import abstract_params, meta_dtensor
from repro_torch.optim import get_optimizer
from repro_torch.sharding.policy import (
    DEFAULT_RULES,
    LONG_DECODE_RULES,
    ResolveLog,
    Spec,
    mesh_axes,
    resolve,
)


def rules_for(cfg, shape_name: str, overrides: Optional[dict] = None) -> dict:
    rules = dict(LONG_DECODE_RULES if shape_name == "long_500k" else DEFAULT_RULES)
    rules.update(dict(cfg.sharding_overrides))
    if overrides:
        rules.update(overrides)
    return rules


def _batch_spec(mesh, rules, batch: int) -> Spec:
    """Batch-dim spec; drops axes the batch size cannot be divided over
    (long_500k has global_batch=1 — batch stays replicated and the cache
    sequence dim carries the sharding instead, per LONG_DECODE_RULES)."""
    sizes = mesh_axes(mesh)
    axes = []
    prod = 1
    for a in rules.get("batch") or ():
        if a in sizes and batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return Spec(tuple(axes) if axes else None)


def extras_specs(cfg, batch: int, mesh, rules) -> Dict[str, Any]:
    bspec = _batch_spec(mesh, rules, batch)
    ex: Dict[str, Any] = {}
    if cfg.encoder is not None:
        ex["frames"] = meta_dtensor(
            (batch, cfg.encoder.n_frames, cfg.d_model), cfg.dtype, mesh,
            Spec(*bspec, None, None),
        )
    elif cfg.cross_attn_every is not None:
        ex["vision_embeds"] = meta_dtensor(
            (batch, cfg.n_vision_tokens, cfg.d_model), cfg.dtype, mesh,
            Spec(*bspec, None, None),
        )
    return ex


def _is_sd(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple)


def _sd_leaves(tree, path: Tuple[str, ...] = ()):
    if _is_sd(tree):
        yield path, tree
        return
    for key, sub in tree.items():
        yield from _sd_leaves(sub, path + (key,))


def _set(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _cache_abstract(cfg, batch: int, max_len: int, mesh, rules, log=None):
    """One dict of meta DTensors per layer (``CausalLM.prefill``'s caches).
    A scanned slot's leaf is resolved once on its stacked shape, in the
    reference's (sorted) tree order."""
    tree = blocks.cache_specs_tree(cfg, batch, max_len)
    period, n_groups, _kinds, _tail = blocks.stack_layout(cfg)
    members: Dict[Tuple[str, ...], list] = {}
    for layer, sub in enumerate(tree):
        if layer < n_groups * period:
            ref = ("scan", f"slot{layer % period}")
        else:
            ref = ("tail", f"layer{layer - n_groups * period}")
        for path, sd in _sd_leaves(sub):
            members.setdefault(ref + path, []).append((layer, path, sd))
    out = [{} for _ in tree]
    for ref_path in sorted(members):
        shape, axes, dtype = members[ref_path][0][2]
        if ref_path[0] == "scan":
            spec = Spec(*resolve((n_groups,) + shape, (None,) + axes, mesh, rules, log)[1:])
        else:
            spec = resolve(shape, axes, mesh, rules, log)
        for layer, path, _sd in members[ref_path]:
            _set(out[layer], path, meta_dtensor(shape, dtype, mesh, spec))
    return out


def input_specs(arch: str, shape_name: str, mesh,
                rules: Optional[dict] = None,
                lr: float = 3e-4) -> Tuple[Dict[str, Any], Any, ResolveLog]:
    """Returns (kwargs_specs, cfg, resolve_log) for the shape's step fn
    (``mesh``: a ``DeviceMesh`` over an initialized process group).

    kwargs keys per kind:
      train   -> model, opt_state, step, batch{tokens, labels, extras}
      prefill -> model, tokens, extras
      decode  -> model, caches, token, position, extras

    ``model`` is a :class:`CausalLM` built on ``meta`` whose parameters are
    meta DTensors (the reference's ``params``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rules = rules or rules_for(cfg, shape_name)
    log = ResolveLog()

    model = CausalLM(cfg, device="meta")
    params = abstract_params(model, mesh, rules, log)
    gb, seq = shape.global_batch, shape.seq_len
    bspec = _batch_spec(mesh, rules, gb)
    specs: Dict[str, Any] = {"model": model}

    if shape.kind == "train":
        opt = get_optimizer(cfg, lr=lr)
        # The reference's eval_shape of init: the state of meta stand-ins
        # at the global shapes, then placed like the parameters (ZeRO-1).
        plain = {k: torch.empty(p.shape, dtype=p.dtype, device="meta")
                 for k, p in params.items()}
        specs["opt_state"] = _reshard_like(opt.init(plain), params, mesh)
        specs["step"] = torch.empty((), dtype=torch.int32, device="meta")
        specs["batch"] = {
            "tokens": meta_dtensor((gb, seq), torch.int32, mesh, Spec(*bspec, None)),
            "labels": meta_dtensor((gb, seq), torch.int32, mesh, Spec(*bspec, None)),
        }
        ex = extras_specs(cfg, gb, mesh, rules)
        if ex:
            specs["batch"]["extras"] = ex
    elif shape.kind == "prefill":
        specs["tokens"] = meta_dtensor((gb, seq), torch.int32, mesh, Spec(*bspec, None))
        specs["extras"] = extras_specs(cfg, gb, mesh, rules)
    else:  # decode
        specs["caches"] = _cache_abstract(cfg, gb, seq, mesh, rules, log)
        specs["token"] = meta_dtensor((gb, 1), torch.int32, mesh, Spec(*bspec, None))
        specs["position"] = meta_dtensor((gb,), torch.int32, mesh, bspec)
        specs["extras"] = extras_specs(cfg, gb, mesh, rules)
    return specs, cfg, log


def _tree_paths(tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _tree_paths(sub, path + (key,))
    else:
        yield path, tree


def _reshard_like(opt_state, params, mesh):
    """Give optimizer-state leaves the sharding of their parameter where
    shapes match; replicate reduced (factored) leaves. A parameter's path is
    its ``state_dict`` key split at the dots."""
    flat_params = {tuple(k.split(".")): p for k, p in params.items()}

    def match(path, leaf):
        path = tuple(part for key in path for part in key.split("."))
        # The parameter whose path is a contiguous run of the state's path
        # (('m', <key...>) for AdamW), else the reference's scan.
        for i in range(len(path)):
            for j in range(len(path), i, -1):
                p = flat_params.get(path[i:j])
                if p is not None and p.shape == leaf.shape:
                    return p
        for ppath, p in flat_params.items():
            if p.shape == leaf.shape and _suffix_match(path, ppath):
                return p
        return None

    out: dict = {}
    for path, leaf in _tree_paths(opt_state):
        p = match(path, leaf)
        if p is not None:
            t = meta_dtensor(leaf.shape, leaf.dtype, mesh, _spec_of(p))
        else:
            t = meta_dtensor(leaf.shape, leaf.dtype, mesh, Spec(*(None,) * leaf.ndim))
        _set(out, path, t)
    return out


def _spec_of(t) -> Spec:
    """The :class:`Spec` of a DTensor's placements on its named mesh."""
    names = t.device_mesh.mesh_dim_names
    parts: list = [()] * t.ndim
    for name, pl in zip(names, t.placements):
        if pl.is_shard():
            parts[pl.dim] = parts[pl.dim] + (name,)
    return Spec(*(None if not a else a[0] if len(a) == 1 else a for a in parts))


def _suffix_match(opt_path, param_path) -> bool:
    """Optimizer paths look like ('m', <param path...>) or (<param path...>, 'v')."""
    pp = list(param_path)
    op = [p for p in opt_path]
    i, j = 0, 0
    while i < len(op) and j < len(pp):
        if op[i] == pp[j]:
            i += 1
            j += 1
        else:
            i += 1
    return j == len(pp)
