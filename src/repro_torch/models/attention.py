"""Attention: GQA, qk-norm, RoPE, sliding window, cross-attention, KV cache.

One implementation serves every architecture, with the JAX package's
arithmetic (``models/attention.py``): scores in f32, masked to ``NEG_INF``,
``softmax``, then cast back to the activation dtype.

* GQA with any ``n_kv_heads``: queries grouped as ``[B, S, Hkv, G, dh]``.
* ``chunked`` full-sequence path: online softmax over KV chunks, which bounds
  the live scores at long sequence lengths.
* Sliding-window layers keep a ring-buffer cache of ``window`` slots with an
  explicit per-slot position array, so local layers cost O(window) memory at
  decode whatever the sequence length.
* Cross-attention (vlm / enc-dec) reuses the same code without RoPE or causal
  masking; its KV is computed once at prefill and cached.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.module import ParamSpec

NEG_INF = -2.0e38


# --------------------------------------------------------------------- #
# Specs
# --------------------------------------------------------------------- #
def attention_specs(cfg, cross: bool = False) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = cfg.param_dtype
    specs = {
        "wq": ParamSpec((d, hq * dh), ("embed", "heads"), dtype=pd),
        "wk": ParamSpec((d, hkv * dh), ("embed", "kv_heads"), dtype=pd),
        "wv": ParamSpec((d, hkv * dh), ("embed", "kv_heads"), dtype=pd),
        "wo": ParamSpec((hq * dh, d), ("heads", "embed"), dtype=pd),
    }
    if cfg.qk_norm and not cross:
        specs["qnorm"] = {"scale": ParamSpec((dh,), (None,), init="ones")}
        specs["knorm"] = {"scale": ParamSpec((dh,), (None,), init="ones")}
    return specs


def _project_q(p, x, cfg):
    b, s, _ = x.shape
    q = (x @ p.wq.to(cfg.dtype)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    if "qnorm" in p:
        q = rmsnorm(p.qnorm, q, cfg.norm_eps)
    return q


def _project_kv(p, x, cfg):
    b, s, _ = x.shape
    k = (x @ p.wk.to(cfg.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p.wv.to(cfg.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if "knorm" in p:
        k = rmsnorm(p.knorm, k, cfg.norm_eps)
    return k, v


def _out_proj(p, ctx, cfg):
    b, s = ctx.shape[:2]
    return ctx.reshape(b, s, -1) @ p.wo.to(cfg.dtype)


# --------------------------------------------------------------------- #
# Full-sequence attention (prefill)
# --------------------------------------------------------------------- #
def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """[.., S_q, S_kv] bool validity mask from position grids."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    m = torch.ones_like(d, dtype=torch.bool)
    if causal:
        m &= d >= 0
    if window is not None:
        m &= d < window
    return m


def _scores(q, k):
    """f32 scores ``[B, Hkv, G, Sq, Skv]``, scaled by ``1/sqrt(dh)``."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float()
    return s / math.sqrt(q.shape[-1])


def _sdpa(q, k, v, mask):
    """q: [B,Sq,Hkv,G,dh]; k/v: [B,Skv,Hkv,dh]; mask: [B,Sq,Skv] or None."""
    scores = _scores(q, k)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def _sdpa_chunked(q, k, v, q_pos, kv_pos, causal, window, chunk):
    """Online softmax over KV chunks: O(S * chunk) live scores."""
    b, sq, hkv, g, dh = q.shape
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kc, vc, pc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], kv_pos[:, c0:c0 + chunk]
        s = _scores(q, kc)
        msk = _mask(q_pos, pc, causal, window)  # [b, sq, chunk]
        s = s.masked_fill(~msk[:, None, None, :, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(q.dtype), vc).float()
        m = m_new
    ctx = acc / l.clamp_min(1e-30)[..., None]
    return ctx.permute(0, 3, 1, 2, 4).to(q.dtype)  # [b, sq, hkv, g, dh]


def attention(
    p,
    x,
    cfg,
    *,
    positions,  # [B, S] integer
    causal: bool = True,
    window: Optional[int] = None,
    theta: Optional[float] = None,
    kv_src=None,  # cross-attention source [B, S_kv, D]
):
    """Full-sequence attention (prefill). Returns (out, (k, v))."""
    b, s, _ = x.shape
    theta = cfg.rope_theta if theta is None else theta
    q = _project_q(p, x, cfg)
    src = x if kv_src is None else kv_src
    k, v = _project_kv(p, src, cfg)
    if kv_src is None:  # self-attention: RoPE on q and k
        kv_pos = positions
        q = apply_rope(q, positions, theta, cfg.rope_fraction)
        k = apply_rope(k, positions, theta, cfg.rope_fraction)
    else:
        kv_pos = torch.arange(src.shape[1], device=x.device).expand(b, src.shape[1])
    qg = q.reshape(b, s, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim)

    use_chunked = cfg.attention_impl == "chunked" or (
        cfg.attention_impl == "auto"
        and src.shape[1] > 2048
        and src.shape[1] % cfg.attn_chunk == 0
    )
    if use_chunked:
        ctx = _sdpa_chunked(qg, k, v, positions, kv_pos, causal, window, cfg.attn_chunk)
    else:
        mask = _mask(positions, kv_pos, causal, window) if (causal or window) else None
        ctx = _sdpa(qg, k, v, mask)
    return _out_proj(p, ctx, cfg), (k, v)


# --------------------------------------------------------------------- #
# KV cache + decode step
# --------------------------------------------------------------------- #
def init_cache_layer(cfg, batch: int, max_len: int, window: Optional[int], device=None):
    """Cache dict for one attention layer (a ring buffer for local layers)."""
    slots = min(window, max_len) if window is not None else max_len
    shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "slot_pos": torch.full((batch, slots), -1, dtype=torch.long, device=device),
    }


def cache_write(cache, k_new, v_new, positions):
    """Write S_new entries at their ring slots, in place. positions:
    [B, S_new], consecutive and ascending along each row.

    Only the last ``slots`` positions of a row are written. A prefill longer
    than a sliding window's ring maps several positions to one slot, and the
    reference's scatter keeps the last write; writing only the last
    ``slots`` positions gives that result with no duplicate index, where
    torch leaves a scatter with duplicates undefined (on CUDA above all).
    """
    slots = cache["k"].shape[1]
    if positions.shape[1] > slots:
        k_new, v_new, positions = k_new[:, -slots:], v_new[:, -slots:], positions[:, -slots:]
    slot = positions % slots  # [B, S_new]
    b_idx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    cache["k"][b_idx, slot] = k_new.to(cache["k"].dtype)
    cache["v"][b_idx, slot] = v_new.to(cache["v"].dtype)
    cache["slot_pos"][b_idx, slot] = positions.to(cache["slot_pos"].dtype)
    return cache


def attention_decode(
    p,
    x,  # [B, 1, D]
    cache,
    cfg,
    *,
    position,  # [B] integer current position
    window: Optional[int] = None,
    theta: Optional[float] = None,
    cross: bool = False,
):
    """One-token decode against the cache, which a self-attention layer
    updates in place. Returns (out, cache)."""
    b = x.shape[0]
    theta = cfg.rope_theta if theta is None else theta
    q = _project_q(p, x, cfg)  # [B, 1, Hq, dh]
    pos2 = position[:, None]
    if not cross:
        q = apply_rope(q, pos2, theta, cfg.rope_fraction)
        k_new, v_new = _project_kv(p, x, cfg)
        k_new = apply_rope(k_new, pos2, theta, cfg.rope_fraction)
        cache = cache_write(cache, k_new, v_new, pos2)
    qg = q.reshape(b, 1, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim)

    slot_pos = cache["slot_pos"]
    scores = _scores(qg, cache["k"])
    valid = slot_pos >= 0
    if not cross:
        valid &= slot_pos <= pos2
        if window is not None:
            valid &= (pos2 - slot_pos) < window
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", probs, cache["v"])
    return _out_proj(p, ctx, cfg), cache
