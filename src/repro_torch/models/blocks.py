"""Decoder blocks and the layer stack.

Every architecture is a periodic pattern of block kinds (attention / SSM /
dense MLP / MoE / cross-attention / local / global). The JAX package stacks
parameters per period slot and scans over groups of one period, with an
unrolled tail (gemma3: 62 = 10 x 6 + 2); ``stack_layout`` is that layout.
The port keeps one :class:`Block` per layer in an ``nn.ModuleList``, in
layer order: the reference's ``scan[g]["slot{i}"]`` is layer
``g * period + i``, and the tail follows.

Training remats as the reference does (``cfg.remat``): each group of one
pattern period is checkpointed, the tail is not (:func:`stack_apply`).

Caches are a list with one dict per layer: ``"attn"`` (the KV ring buffer),
``"ssm"`` (state and conv tail) and ``"cross_kv"`` (the cross-attention
source's keys and values, computed once at prefill).
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import norm, norm_specs
from repro_torch.models.mlp import gelu_mlp, gelu_mlp_specs, swiglu, swiglu_specs
from repro_torch.models.moe import moe, moe_specs
from repro_torch.models.module import ParamSpec, SpecModule


# --------------------------------------------------------------------- #
# Layer kinds
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LayerKind:
    attn: bool
    ssm: bool
    moe: bool
    cross: bool
    window: Optional[int]
    theta: float
    causal: bool = True


def layer_kind(cfg, idx: int, causal: bool = True, allow_cross: bool = True) -> LayerKind:
    is_attn = cfg.is_attn_layer(idx)
    window = None
    theta = cfg.rope_theta
    if is_attn and cfg.sliding_window is not None:
        if cfg.is_global_layer(idx):
            theta = cfg.rope_global_theta or cfg.rope_theta
        else:
            window = cfg.sliding_window
    return LayerKind(
        attn=is_attn,
        ssm=not is_attn,
        moe=cfg.is_moe_layer(idx),
        cross=allow_cross and cfg.is_cross_layer(idx),
        window=window,
        theta=theta,
        causal=causal,
    )


def pattern_period(cfg) -> int:
    period = 1
    for cycle in (cfg.global_every, cfg.attn_every, cfg.cross_attn_every,
                  cfg.moe.every_k_layers if cfg.moe else None):
        if cycle:
            period = math.lcm(period, cycle)
    return period


def stack_layout(cfg, n_layers: Optional[int] = None, causal: bool = True,
                 allow_cross: bool = True):
    """The reference's (period, n_groups, slot kinds, tail kinds)."""
    n_layers = n_layers if n_layers is not None else cfg.n_layers
    period = pattern_period(cfg)
    n_groups, tail = divmod(n_layers, period)
    if n_groups == 0:
        period, n_groups, tail = 1, 0, n_layers
    kinds = [layer_kind(cfg, i, causal, allow_cross) for i in range(period)]
    tail_kinds = [
        layer_kind(cfg, n_groups * period + i, causal, allow_cross)
        for i in range(tail)
    ]
    return period, n_groups, kinds, tail_kinds


def layer_kinds(cfg, n_layers: Optional[int] = None, causal: bool = True,
                allow_cross: bool = True) -> List[LayerKind]:
    """The kind of every layer, in layer order."""
    _period, n_groups, kinds, tail_kinds = stack_layout(cfg, n_layers, causal, allow_cross)
    return kinds * n_groups + tail_kinds


# --------------------------------------------------------------------- #
# One block
# --------------------------------------------------------------------- #
def block_specs(cfg, kind: LayerKind) -> dict:
    specs: Dict[str, Any] = {}
    if kind.cross:
        specs["cross_norm"] = norm_specs(cfg)
        specs["cross"] = attn_lib.attention_specs(cfg, cross=True)
        specs["cross_gate"] = ParamSpec((), (), init="zeros")
    specs["pre_norm"] = norm_specs(cfg)
    if kind.attn:
        specs["attn"] = attn_lib.attention_specs(cfg)
    else:
        specs["ssm"] = ssm_lib.ssm_specs(cfg)
    if cfg.post_norms:
        specs["post_norm"] = norm_specs(cfg)
    if kind.moe:
        specs["mlp_norm"] = norm_specs(cfg)
        specs["moe"] = moe_specs(cfg)
    elif cfg.d_ff > 0:
        specs["mlp_norm"] = norm_specs(cfg)
        if cfg.mlp_type == "gelu":
            specs["mlp"] = gelu_mlp_specs(cfg.d_model, cfg.d_ff, cfg.param_dtype)
        else:
            specs["mlp"] = swiglu_specs(cfg.d_model, cfg.d_ff, cfg.param_dtype)
    return specs


class Block(SpecModule):
    """One layer: its parameters (``block_specs``) and its kind."""

    def __init__(self, cfg, kind: LayerKind, device=None):
        super().__init__(block_specs(cfg, kind), device)
        self.kind = kind

    def _mlp_part(self, x, cfg):
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if "mlp_norm" not in self:  # pure-SSM blocks (mamba2) have no FFN
            return x, zero
        h = norm(self.mlp_norm, x, cfg)
        if self.kind.moe:
            out, aux = moe(self.moe, h, cfg)
        elif cfg.mlp_type == "gelu":
            out, aux = gelu_mlp(self.mlp, h, cfg), zero
        else:
            out, aux = swiglu(self.mlp, h, cfg), zero
        return x + out, aux

    def _cross_gate(self, x):
        return torch.tanh(self.cross_gate).to(x.dtype)

    def forward(self, x, cfg, ctx, collect_cache: bool = False):
        """Full-sequence block. ctx: positions [B, S], cross_src, max_len.

        Returns (x, aux, cache or None)."""
        kind = self.kind
        cache = {}
        if kind.cross:
            h = norm(self.cross_norm, x, cfg)
            c_out, (ck, cv) = attn_lib.attention(
                self.cross, h, cfg, positions=ctx["positions"], causal=False,
                kv_src=ctx["cross_src"],
            )
            x = x + self._cross_gate(x) * c_out
            if collect_cache:
                src_pos = torch.arange(ck.shape[1], device=ck.device).expand(ck.shape[:2])
                cache["cross_kv"] = {"k": ck, "v": cv, "slot_pos": src_pos}
        h = norm(self.pre_norm, x, cfg)
        if kind.attn:
            a_out, (k, v) = attn_lib.attention(
                self.attn, h, cfg, positions=ctx["positions"], causal=kind.causal,
                window=kind.window, theta=kind.theta,
            )
            if collect_cache:
                lc = attn_lib.init_cache_layer(cfg, x.shape[0], ctx["max_len"], kind.window,
                                               x.device)
                cache["attn"] = attn_lib.cache_write(lc, k, v, ctx["positions"])
        else:
            a_out, ssm_cache = ssm_lib.ssm_block(self.ssm, h, cfg, return_cache=collect_cache)
            if collect_cache:
                cache["ssm"] = ssm_cache
        if cfg.post_norms:
            a_out = norm(self.post_norm, a_out, cfg)
        x, aux = self._mlp_part(x + a_out, cfg)
        return x, aux, (cache if collect_cache else None)

    def decode(self, x, cache, cfg, ctx):
        """One-token step. ctx: position [B]. Returns (x, new cache)."""
        kind = self.kind
        new_cache = dict(cache)
        if kind.cross:
            h = norm(self.cross_norm, x, cfg)
            c_out, _ = attn_lib.attention_decode(
                self.cross, h, cache["cross_kv"], cfg, position=ctx["position"], cross=True,
            )
            x = x + self._cross_gate(x) * c_out
        h = norm(self.pre_norm, x, cfg)
        if kind.attn:
            a_out, new_cache["attn"] = attn_lib.attention_decode(
                self.attn, h, cache["attn"], cfg, position=ctx["position"],
                window=kind.window, theta=kind.theta,
            )
        else:
            a_out, new_cache["ssm"] = ssm_lib.ssm_block_decode(self.ssm, h, cache["ssm"], cfg)
        if cfg.post_norms:
            a_out = norm(self.post_norm, a_out, cfg)
        x, _ = self._mlp_part(x + a_out, cfg)
        return x, new_cache


# --------------------------------------------------------------------- #
# Stack
# --------------------------------------------------------------------- #
def build_layers(cfg, n_layers: Optional[int] = None, causal: bool = True,
                 allow_cross: bool = True, device=None) -> nn.ModuleList:
    return nn.ModuleList(Block(cfg, kind, device)
                         for kind in layer_kinds(cfg, n_layers, causal, allow_cross))


def _save_weight_products(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the outputs of products with no batch
    dimension (``x @ W`` reaches ``aten.mm``), recompute the rest (the
    attention's and the experts' batched products, norms, activations)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """The reference's ``_maybe_remat``: ``full`` recomputes the whole group
    in backward, ``dots`` mirrors ``checkpoint_dots_with_no_batch_dims``."""
    if cfg.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat == "dots":
        return lambda *a: checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=partial(create_selective_checkpoint_contexts, _save_weight_products))
    return fn


def stack_apply(layers, x, cfg, ctx, collect_cache: bool = False):
    """Run the whole stack. Returns (x, aux_total, caches or None).

    With ``cfg.remat`` other than ``none`` and autograd recording, each
    group of one pattern period (the reference's scan body) runs under
    activation checkpointing; the unrolled tail does not, as in the
    reference. Serving (``collect_cache``) never remats."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    period = pattern_period(cfg)
    n_groups = len(layers) // period
    if cfg.remat != "none" and not collect_cache and torch.is_grad_enabled() and n_groups:
        def group_fn(x, g):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for block in layers[g * period:(g + 1) * period]:
                x, a, _ = block(x, cfg, ctx)
                aux = aux + a
            return x, aux

        run = _remat(group_fn, cfg)
        for g in range(n_groups):
            x, a = run(x, g)
            aux = aux + a
        rest = layers[n_groups * period:]
    else:
        rest = layers
    for block in rest:
        x, a, c = block(x, cfg, ctx, collect_cache)
        aux = aux + a
        caches.append(c)
    return x, aux, (caches if collect_cache else None)


def _block_cache_specs(cfg, kind: LayerKind, batch: int, max_len: int):
    spec: Dict[str, Any] = {}
    if kind.cross:
        n_src = cfg.encoder.n_frames if cfg.encoder else cfg.n_vision_tokens
        kv = ((batch, n_src, cfg.n_kv_heads, cfg.head_dim),
              ("cache_batch", None, "kv_heads", None), cfg.dtype)
        spec["cross_kv"] = {"k": kv, "v": kv,
                            "slot_pos": ((batch, n_src), ("cache_batch", None), torch.long)}
    if kind.attn:
        spec["attn"] = attn_lib.cache_layer_specs(cfg, batch, max_len, kind.window)
    else:
        spec["ssm"] = ssm_lib.ssm_cache_specs(cfg, batch)
    return spec


def cache_specs_tree(cfg, batch: int, max_len: int,
                     n_layers: Optional[int] = None) -> List[Dict[str, Any]]:
    """(shape, logical axes, dtype) leaves of the caches ``CausalLM.prefill``
    returns: one dict per layer, in layer order. The reference stacks a
    scanned slot's leaves ``[n_groups, ...]`` with a leading unsharded axis;
    each of its slices is one layer's leaf here."""
    return [_block_cache_specs(cfg, kind, batch, max_len)
            for kind in layer_kinds(cfg, n_layers)]


def stack_decode(layers, x, caches, cfg, ctx):
    """One-token step through the stack. Returns (x, new caches)."""
    new_caches = []
    for block, cache in zip(layers, caches):
        x, c = block.decode(x, cache, cfg, ctx)
        new_caches.append(c)
    return x, new_caches
