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

from repro_torch.models.layers import (apply_rope, as_layout, fsdp_matmul, mesh_of, on_shards,
                                       rmsnorm, shard_start, whole_units, with_logical)
from repro_torch.models.module import ParamSpec, dtensor_of
from repro_torch.sharding import policy

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
    q = whole_units(fsdp_matmul(x, p.wq.to(cfg.dtype)), cfg.n_heads, "heads")
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    q = with_logical(q, ("batch", None, "heads", None))
    if "qnorm" in p:
        q = rmsnorm(p.qnorm, q, cfg.norm_eps)
    return q


def _project_kv(p, x, cfg):
    b, s, _ = x.shape
    k = whole_units(fsdp_matmul(x, p.wk.to(cfg.dtype)), cfg.n_kv_heads, "kv_heads")
    v = whole_units(fsdp_matmul(x, p.wv.to(cfg.dtype)), cfg.n_kv_heads, "kv_heads")
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    k = with_logical(k, ("batch", None, "kv_heads", None))
    v = with_logical(v, ("batch", None, "kv_heads", None))
    if "knorm" in p:
        k = rmsnorm(p.knorm, k, cfg.norm_eps)
    return k, v


def _out_proj(p, ctx, cfg):
    b, s = ctx.shape[:2]
    ctx = whole_units(ctx.reshape(b, s, -1), cfg.n_heads, "heads")
    return with_logical(fsdp_matmul(ctx, p.wo.to(cfg.dtype)), ("batch", None, None))


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


# --------------------------------------------------------------------- #
# Attention on local shards
# --------------------------------------------------------------------- #
# Attention is independent across batch rows and heads, so on a mesh each
# rank attends with its own rows and heads (:func:`on_shards`), as a
# tensor-parallel attention kernel does; on one card the same code runs on
# the whole tensors. (Left to DTensor, the products that merge a sharded
# batch dim with sharded heads need strided shardings, whose redistribution
# planning does not finish on a 3-D mesh.)
def _group_heads(q, k, v, h0, k0, cfg):
    """Local ``q`` [B, S, Hq, dh] (its first head global head ``h0``)
    grouped as [B, S, n_kv, G, dh] over the kv heads it reads, and those kv
    heads of the local ``k``, ``v`` (first head ``k0``): ``(qg, k, v)``."""
    g_all = cfg.q_per_kv
    b, s, n_q, dh = q.shape
    first = h0 // g_all
    n_kv = max(1, n_q // g_all)
    if not ((n_q % g_all == 0 and h0 % g_all == 0)
            or (g_all % n_q == 0 and (h0 + n_q - 1) // g_all == first)):
        raise NotImplementedError(f"local q heads [{h0}, {h0 + n_q}) do not map onto whole "
                                  f"kv heads of {g_all} q heads each")
    if k.shape[2] != n_kv:
        k, v = (t[:, :, first - k0:first - k0 + n_kv] for t in (k, v))
    return q.reshape(b, s, n_kv, n_q // n_kv, dh), k, v


def _heads_layout(q, k, mesh):
    """Placements for attention on local shards: ``q`` by rows and heads;
    ``k``, ``v`` by ``q``'s rows and their own heads; positions by ``q``'s
    rows."""
    from torch.distributed.tensor import Replicate

    q_pl = policy.placements(policy.logical_spec(q.shape, ("batch", None, "heads", None)), mesh)
    k_pl = policy.placements(policy.logical_spec(k.shape, ("batch", None, "kv_heads", None)), mesh)
    kv_pl = tuple(pq if pq.is_shard(0) else pk if pk.is_shard(2) else Replicate()
                  for pq, pk in zip(q_pl, k_pl))
    pos_pl = tuple(p if p.is_shard(0) else Replicate() for p in q_pl)
    return q_pl, kv_pl, pos_pl


def _attend(q, k, v, q_pos, kv_pos, causal, window, cfg, chunked):
    """Full-sequence attention of ``q`` [B, S, H, dh] and ``k``, ``v``
    [B, S_kv, Hkv, dh]: the context [B, S, H, dh], on a mesh laid out like
    ``q``'s rows and heads."""
    mesh = mesh_of(q)
    h0 = k0 = 0
    ins = out = None
    if mesh is not None:
        q_pl, kv_pl, pos_pl = _heads_layout(q, k, mesh)
        h0, k0 = shard_start(q.shape, mesh, q_pl, 2), shard_start(k.shape, mesh, kv_pl, 2)
        ins, out = (q_pl, kv_pl, kv_pl, pos_pl, pos_pl), (q_pl,)

    def core(q, k, v, q_pos, kv_pos):
        qg, k, v = _group_heads(q, k, v, h0, k0, cfg)
        if chunked:
            ctx = _sdpa_chunked(qg, k, v, q_pos, kv_pos, causal, window, cfg.attn_chunk)
        else:
            mask = _mask(q_pos, kv_pos, causal, window) if (causal or window) else None
            ctx = _sdpa(qg, k, v, mask)
        return ctx.reshape(q.shape)

    return on_shards(core, mesh, ins, out)(q, k, v, q_pos, kv_pos)


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

    use_chunked = cfg.attention_impl == "chunked" or (
        cfg.attention_impl == "auto"
        and src.shape[1] > 2048
        and src.shape[1] % cfg.attn_chunk == 0
    )
    ctx = _attend(q, k, v, positions, kv_pos, causal, window, cfg, use_chunked)
    return _out_proj(p, ctx, cfg), (k, v)


# --------------------------------------------------------------------- #
# KV cache + decode step
# --------------------------------------------------------------------- #
def init_cache_layer(cfg, batch: int, max_len: int, window: Optional[int], device=None):
    """Cache dict for one attention layer (a ring buffer for local layers):
    zeros, and -1 in ``slot_pos``. Under an active ``DeviceMesh`` (the
    dry-run) its leaves are DTensors laid out by their logical axes
    (:func:`cache_layer_specs`), each rank holding its shard."""
    mesh = policy.active_device_mesh()
    out = {}
    for name, (shape, axes, dtype) in cache_layer_specs(cfg, batch, max_len, window).items():
        fill = -1 if name == "slot_pos" else 0
        if mesh is None:
            out[name] = torch.full(shape, fill, dtype=dtype, device=device)
        else:
            spec = policy.logical_spec(shape, axes)
            local = torch.full(policy.local_shape(shape, spec, mesh), fill, dtype=dtype,
                               device=device)
            out[name] = dtensor_of(local, shape, mesh, spec)
    return out


def cache_layer_specs(cfg, batch: int, max_len: int, window: Optional[int]):
    """(shape, logical axes, dtype) of each leaf of :func:`init_cache_layer`,
    for the dry-run's input specs."""
    slots = min(window, max_len) if window is not None else max_len
    kv = ((batch, slots, cfg.n_kv_heads, cfg.head_dim),
          ("cache_batch", "cache_seq", "kv_heads", None))
    return {
        "k": (kv[0], kv[1], cfg.dtype),
        "v": (kv[0], kv[1], cfg.dtype),
        "slot_pos": ((batch, slots), ("cache_batch", "cache_seq"), torch.long),
    }


def cache_write(cache, k_new, v_new, positions):
    """Write S_new entries at their ring slots, in place. positions:
    [B, S_new], consecutive and ascending along each row.

    Only the last ``slots`` positions of a row are written. A prefill longer
    than a sliding window's ring maps several positions to one slot, and the
    reference's scatter keeps the last write; writing only the last
    ``slots`` positions gives that result with no duplicate index, where
    torch leaves a scatter with duplicates undefined (on CUDA above all).

    On a mesh each rank writes into its own shard of the cache: the rows it
    holds, and, where the slot dim is sharded (long-context decode), only
    the entries that fall in its slot range (one position per step).
    """
    ck = cache["k"]
    slots = ck.shape[1]
    if positions.shape[1] > slots:
        k_new, v_new, positions = k_new[:, -slots:], v_new[:, -slots:], positions[:, -slots:]
    mesh = mesh_of(ck)
    new = {"k": k_new, "v": v_new, "slot_pos": positions}
    slot_sharded = mesh is not None and any(p.is_shard(1) for p in ck.placements)
    if mesh is not None:
        from torch.distributed.tensor import Replicate

        if slot_sharded and positions.shape[1] != 1:
            raise NotImplementedError("a write of several positions into a cache whose slot "
                                      "dim is sharded")
        rows = tuple(p if p.is_shard(0) else Replicate() for p in ck.placements)
        kv = tuple(Replicate() if p.is_shard(1) else p for p in ck.placements)
        new = {name: as_layout(t, mesh, rows if name == "slot_pos" else kv).to_local()
               for name, t in new.items()}
        positions = new["slot_pos"]
    slot = positions % slots  # [B, S_new]
    b_idx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    if slot_sharded:
        n_local = ck.to_local().shape[1]
        slot = slot - shard_start(ck.shape, mesh, ck.placements, 1)
        inside = (slot >= 0) & (slot < n_local)
        slot = slot.clamp(0, n_local - 1)
    for name in ("k", "v", "slot_pos"):
        dest = cache[name].to_local() if mesh is not None else cache[name]
        vals = new[name].to(dest.dtype)
        if slot_sharded:  # a rank outside the slot writes back what it holds
            keep = inside.reshape(inside.shape + (1,) * (vals.ndim - 2))
            vals = torch.where(keep, vals, dest[b_idx, slot])
        dest[b_idx, slot] = vals
    return cache


def _decode_attend(q, cache, pos2, window, cross, cfg):
    """One-token attention of ``q`` [B, 1, H, dh] against the cache. On a
    mesh each rank attends with its rows, heads and slots; where the slot
    dim is sharded (long-context decode), each rank holds a slice of the
    slots and the softmax is combined across the slot shards (flash-decode:
    an all-reduce of the max, of the sum, and of the context)."""
    kc, vc, sp = cache["k"], cache["v"], cache["slot_pos"]
    mesh = mesh_of(kc)
    h0 = k0 = 0
    slot_dims = ()
    ins = out = None
    if mesh is not None:
        from torch.distributed.tensor import Replicate, Shard

        q_heads, _, _ = _heads_layout(q, kc, mesh)
        q_pl = tuple(Shard(0) if pc.is_shard(0) else Replicate() if pc.is_shard(1)
                     else Shard(2) if pq.is_shard(2) else Replicate()
                     for pc, pq in zip(kc.placements, q_heads))
        pos_pl = tuple(p if p.is_shard(0) else Replicate() for p in kc.placements)
        slot_dims = tuple(i for i, p in enumerate(kc.placements) if p.is_shard(1))
        h0, k0 = shard_start(q.shape, mesh, q_pl, 2), shard_start(kc.shape, mesh, kc.placements, 2)
        ins, out = (q_pl, kc.placements, vc.placements, sp.placements, pos_pl), (q_pl,)

    def core(q, k, v, slot_pos, pos2):
        qg, k, v = _group_heads(q, k, v, h0, k0, cfg)
        scores = _scores(qg, k)
        valid = slot_pos >= 0
        if not cross:
            valid &= slot_pos <= pos2
            if window is not None:
                valid &= (pos2 - slot_pos) < window
        scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
        if not slot_dims:
            probs = torch.softmax(scores, dim=-1).to(q.dtype)
            return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(q.shape)
        import torch.distributed._functional_collectives as funcol

        m = scores.amax(dim=-1, keepdim=True)
        for d in slot_dims:
            m = funcol.all_reduce(m, "max", (mesh, d))
        e = torch.exp(scores - m)
        denom = e.sum(dim=-1, keepdim=True)
        for d in slot_dims:
            denom = funcol.all_reduce(denom, "sum", (mesh, d))
        ctx = torch.einsum("bhgqk,bkhd->bqhgd", (e / denom).to(q.dtype), v)
        for d in slot_dims:
            ctx = funcol.all_reduce(ctx, "sum", (mesh, d))
        return ctx.reshape(q.shape)

    return on_shards(core, mesh, ins, out)(q, kc, vc, sp, pos2)


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
    theta = cfg.rope_theta if theta is None else theta
    q = _project_q(p, x, cfg)  # [B, 1, Hq, dh]
    pos2 = position[:, None]
    if not cross:
        q = apply_rope(q, pos2, theta, cfg.rope_fraction)
        k_new, v_new = _project_kv(p, x, cfg)
        k_new = apply_rope(k_new, pos2, theta, cfg.rope_fraction)
        cache = cache_write(cache, k_new, v_new, pos2)
    ctx = _decode_attend(q, cache, pos2, window, cross, cfg)
    return _out_proj(p, ctx, cfg), cache
