"""Analytic FLOPs / HBM-traffic model per (arch x shape): the port of
``repro.roofline.flops_model``, with the same arithmetic in the same order.

The dry-run (``launch/dryrun.py``) traces every operation of a step and
counts its FLOPs and bytes (:class:`repro_torch.roofline.tally.Tally`); this
model is the napkin math beside it, the yardstick the traced counts are held
to (``chip_smoke.py`` checks the traced FLOPs of three steps against it, and
the record keeps both).

Conventions:
  * matmul [m,k]x[k,n]: 2mkn flops.
  * backward = 2x forward; ``remat=full`` re-runs the forward once more.
  * HBM traffic is the *roofline lower bound*: every parameter read once
    per pass, activations written+read once between layers, KV cache
    read/written once — i.e. perfect on-chip fusion.

Dtype sizes come from ``torch.dtype.itemsize``. ``device_memory_model``'s
components are the reference's; the dry-run compares its total with the
H100's 80 GB (``hw.HBM_BYTES``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import blocks


@dataclasses.dataclass
class CostBreakdown:
    flops_total: float  # whole step, all chips
    hbm_bytes_per_device: float
    detail: Dict[str, float]


def _layer_counts(cfg: ModelConfig):
    period, n_groups, kinds, tail_kinds = blocks.stack_layout(cfg)
    all_kinds = kinds * n_groups + tail_kinds
    return all_kinds


def _attn_flops_per_token(cfg, ctx_len: float) -> float:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * d * dh * (2 * hq + 2 * hkv)  # q,o + k,v
    scores = 4 * hq * dh * ctx_len  # QK^T + PV
    return proj + scores


def _cross_flops_per_token(cfg, n_src: int) -> float:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj_q = 2 * d * dh * 2 * hq
    scores = 4 * hq * dh * n_src
    return proj_q + scores


def _mlp_flops_per_token(cfg, kind) -> float:
    if kind.moe:
        m = cfg.moe
        routed = m.top_k * 6 * cfg.d_model * m.d_expert
        shared = 6 * cfg.d_model * m.d_shared if m.n_shared else 0.0
        router = 2 * cfg.d_model * m.n_experts
        return routed + shared + router
    if cfg.d_ff == 0:
        return 0.0
    mult = 4 if cfg.mlp_type == "gelu" else 6
    return mult * cfg.d_model * cfg.d_ff


def _ssm_flops_per_token(cfg) -> float:
    s = cfg.ssm
    d, di, n, h, p = cfg.d_model, s.d_inner(cfg.d_model), s.d_state, s.n_heads(cfg.d_model), s.head_dim
    proj = 2 * d * (2 * di) + 2 * d * (2 * n) + 2 * d * h + 2 * di * d
    conv = 2 * s.d_conv * (di + 2 * n)
    L = s.chunk
    # SSD: intra-chunk CB^T (2LN) + masked matmul to outputs (2*L*h*p per
    # token) + inter-chunk state in/out (4*n*h*p) + state contribution
    # (2*n*h*p).
    ssd = 2 * L * n + 2 * L * h * p + 6 * n * h * p
    return proj + conv + ssd


def _head_flops_per_token(cfg) -> float:
    return 2 * cfg.d_model * cfg.vocab_padded


def _param_bytes(cfg, n_params: int) -> float:
    return float(n_params) * cfg.param_dtype.itemsize


def forward_flops_per_token(cfg: ModelConfig, ctx_len: float, decode: bool = False) -> float:
    """Average per-token forward flops at the given (average) context. The
    encoder (whisper) runs once per sequence and is added by :func:`cost`."""
    total = 0.0
    n_src = cfg.encoder.n_frames if cfg.encoder else cfg.n_vision_tokens
    for kind in _layer_counts(cfg):
        if kind.attn:
            eff_ctx = min(ctx_len, kind.window) if kind.window else ctx_len
            total += _attn_flops_per_token(cfg, eff_ctx)
        else:
            total += _ssm_flops_per_token(cfg)
        if kind.cross:
            total += _cross_flops_per_token(cfg, n_src)
        total += _mlp_flops_per_token(cfg, kind)
    total += _head_flops_per_token(cfg)
    return total


def _encoder_flops(cfg) -> float:
    if cfg.encoder is None:
        return 0.0
    frames = cfg.encoder.n_frames
    per_tok = 0.0
    for i in range(cfg.encoder.n_layers):
        per_tok += _attn_flops_per_token(cfg, frames / 2) + _mlp_flops_per_token(
            cfg, blocks.layer_kind(cfg, i, allow_cross=False)
        )
    return per_tok * frames


def cost(cfg: ModelConfig, shape: ShapeConfig, n_params: int, n_chips: int,
         remat: bool = True) -> CostBreakdown:
    gb, seq = shape.global_batch, shape.seq_len
    detail: Dict[str, float] = {}
    pbytes = _param_bytes(cfg, n_params)

    if shape.kind in ("train", "prefill"):
        tokens = gb * seq
        fwd = forward_flops_per_token(cfg, ctx_len=seq / 2) * tokens
        fwd += _encoder_flops(cfg) * gb
        if shape.kind == "train":
            factor = 3.0 + (1.0 if remat else 0.0)
            flops = fwd * factor
            detail["fwd"] = fwd
            detail["bwd"] = 2 * fwd
            detail["remat"] = fwd if remat else 0.0
            # HBM per device: params (fwd+bwd+remat reads + optimizer rw)
            # + activation stash (per-group boundaries) + grads.
            opt_mult = 5.0  # read p,m,v + write p,m,v -ish (adamw)
            hbm = pbytes * (factor + opt_mult) / n_chips
            act = 2.0 * tokens * cfg.d_model * 2 / n_chips  # bf16 boundaries
            n_layers = cfg.n_layers
            hbm += act * n_layers
            detail["hbm_params"] = pbytes * (factor + opt_mult) / n_chips
            detail["hbm_acts"] = act * n_layers
        else:
            flops = fwd
            hbm = pbytes / n_chips
            act = 2.0 * tokens * cfg.d_model * 2 / n_chips
            hbm += act * cfg.n_layers
            # KV cache write.
            kv = _kv_cache_bytes(cfg, gb, seq)
            hbm += kv / n_chips
            detail["hbm_kv_write"] = kv / n_chips
    else:  # decode: one token per sequence
        fwd = forward_flops_per_token(cfg, ctx_len=seq, decode=True) * gb
        flops = fwd
        kv = _kv_cache_bytes(cfg, gb, seq)
        hbm = pbytes / n_chips + kv / n_chips  # read all params + full cache
        detail["hbm_params"] = pbytes / n_chips
        detail["hbm_kv_read"] = kv / n_chips
    detail["flops_total"] = flops
    return CostBreakdown(flops_total=flops, hbm_bytes_per_device=hbm, detail=detail)


def device_memory_model(cfg, shape, n_params: int, n_chips: int, dp: int,
                        accum_steps: int = 1) -> Dict[str, float]:
    """Analytic per-device memory residency.

    Components: parameters (+grads +optimizer state for train), the remat
    residual stash, per-microbatch live activations, KV caches (decode),
    and a fixed workspace allowance.
    """
    pd = cfg.param_dtype.itemsize
    ad = cfg.dtype.itemsize
    gb, seq = shape.global_batch, shape.seq_len
    out: Dict[str, float] = {}
    out["params"] = n_params * pd / n_chips
    if shape.kind == "train":
        out["grads"] = n_params * 4 / n_chips  # fp32 accumulation buffer
        opt_per_param = 8 if cfg.optimizer == "adamw" else 0.5  # adafactor ~rank-1
        out["opt_state"] = n_params * opt_per_param / n_chips
        micro_rows = max(1, gb // (dp * accum_steps))  # per-device rows
        # Remat stash: one residual per layer boundary per microbatch.
        out["stash"] = float(cfg.n_layers) * micro_rows * seq * cfg.d_model * ad
        # Live working set inside one rematted group (few activation-sized
        # tensors) + logits in fp32 over the model-sharded vocab.
        live = 6 * micro_rows * seq * cfg.d_model * ad
        logits = micro_rows * seq * cfg.vocab_padded * 4 / max(n_chips // dp, 1)
        out["live"] = (live + logits) / 1.0
    elif shape.kind == "prefill":
        rows = max(1, gb // dp)
        out["stash"] = 0.0
        out["live"] = 8 * rows * seq * cfg.d_model * ad
        out["kv_cache"] = _kv_cache_bytes(cfg, gb, seq) / n_chips
    else:
        out["kv_cache"] = _kv_cache_bytes(cfg, gb, seq) / n_chips
        out["live"] = 4 * max(1, gb // dp) * cfg.d_model * ad + cfg.vocab_padded * 4
    out["workspace"] = 512 * 2**20
    out["total"] = float(sum(out.values()))
    return out


def _kv_cache_bytes(cfg, batch: int, seq: int) -> float:
    total = 0.0
    dt = cfg.dtype.itemsize
    for kind in _layer_counts(cfg):
        if kind.attn:
            slots = min(kind.window, seq) if kind.window else seq
            total += 2 * batch * slots * cfg.n_kv_heads * cfg.head_dim * dt
        else:
            s = cfg.ssm
            total += (
                batch * s.n_heads(cfg.d_model) * s.d_state * s.head_dim * 4
                + batch * (s.d_conv - 1) * (s.d_inner(cfg.d_model) + 2 * s.d_state) * dt
            )
        if kind.cross:
            n_src = cfg.encoder.n_frames if cfg.encoder else cfg.n_vision_tokens
            total += 2 * batch * n_src * cfg.n_kv_heads * cfg.head_dim * dt
    return total
