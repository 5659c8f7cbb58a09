"""Mixture-of-Experts with sort-based capacity dispatch.

The JAX package's ``models/moe.py`` dispatch, gather-only, with static
shapes and no [tokens, experts, capacity] one-hot:

  1. route: top-k experts per token (softmax over all, renormalized top-k);
  2. stable-argsort the (token, slot) pairs by expert id; the position
     within an expert comes from a cumulative count, and entries beyond the
     expert capacity are dropped (capacity factor in ``MoEConfig``);
  3. gather tokens into the ``[n_experts, capacity, d_model]`` buffer;
  4. batched-matmul SwiGLU over experts;
  5. gather back through the inverse permutation and combine with the
     router weights.

A switch-style load-balance auxiliary loss is returned alongside. Shared
experts (qwen2-moe) are a plain SwiGLU over the combined shared width,
added to the routed output.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.mlp import swiglu, swiglu_specs
from repro_torch.models.module import ParamSpec


def moe_specs(cfg) -> dict:
    m, d, pd = cfg.moe, cfg.d_model, cfg.param_dtype
    specs = {
        "router": ParamSpec((d, m.n_experts), ("embed", "experts"), init="small", dtype=pd),
        "wi_gate": ParamSpec(
            (m.n_experts, d, m.d_expert), ("experts", "embed", "expert_mlp"), dtype=pd
        ),
        "wi_up": ParamSpec(
            (m.n_experts, d, m.d_expert), ("experts", "embed", "expert_mlp"), dtype=pd
        ),
        "wo": ParamSpec(
            (m.n_experts, m.d_expert, d), ("experts", "expert_mlp", "embed"), dtype=pd
        ),
    }
    if m.n_shared:
        specs["shared"] = swiglu_specs(d, m.d_shared, pd)
    return specs


def _capacity(n_tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to x8


def _gather_rows(x, idx):
    """x: [g, n, d]; idx: [g, m] -> x[g, idx[g, j]]: [g, m, d]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def moe(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss f32 scalar).

    Tokens are dispatched within ``g`` groups, each with its own capacity.
    The reference makes one group per data-parallel shard; one card is one
    group, and the ``g`` dimension stays for a multi-rank port."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k, e = m.top_k, m.n_experts
    g = 1
    tg = t // g  # tokens per dispatch group
    cap = _capacity(tg, cfg)
    xf = x.reshape(g, tg, d)
    dev = x.device

    # --- route -------------------------------------------------------- #
    logits = xf @ p.router.to(cfg.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # [g, tg, k]
    top_w = (top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)).to(cfg.dtype)

    # --- dispatch (sort by expert, within each group; gather-only) ----- #
    # Sorted entries for expert E occupy [start[E], start[E] + counts[E]),
    # so the [e, cap] buffer is a gather with index start[E] + c.
    flat_e = top_e.reshape(g, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # [g, tg*k]
    sorted_e = torch.gather(flat_e, -1, order)
    counts = (flat_e[:, :, None] == torch.arange(e, device=dev)[None, None, :]).sum(1)
    start = torch.cumsum(counts, dim=-1) - counts  # [g, e]

    # Load-balance aux (switch loss): E * sum_e f_e * p_e.
    f = counts.sum(0).float() / (t * k)
    aux = e * (f * probs.mean(dim=(0, 1))).sum()
    pos = torch.arange(tg * k, device=dev)[None, :] - torch.gather(start, -1, sorted_e)
    keep = pos < cap  # [g, tg*k] capacity-dropped slots

    tok_of = order // k  # token index within group, sorted order
    sorted_vals = _gather_rows(xf, tok_of)  # [g, tgk, d]
    slots = torch.arange(cap, device=dev)[None, None, :]
    src = (start[:, :, None] + slots).clamp(0, tg * k - 1).reshape(g, e * cap)
    valid = slots < counts[:, :, None]
    eb = _gather_rows(sorted_vals, src)
    eb = (eb * valid.reshape(g, e * cap, 1).to(cfg.dtype)).reshape(g, e, cap, d)

    # --- expert SwiGLU (batched over groups and experts) --------------- #
    gate = torch.einsum("gecd,edf->gecf", eb, p.wi_gate.to(cfg.dtype))
    up = torch.einsum("gecd,edf->gecf", eb, p.wi_up.to(cfg.dtype))
    h = F.silu(gate) * up
    out_b = torch.einsum("gecf,efd->gecd", h, p.wo.to(cfg.dtype)).reshape(g, e * cap, d)

    # --- combine (gather-only) ------------------------------------------ #
    # Sorted slot j reads buffer row sorted_e[j]*cap + pos[j]; token t's k
    # slots sit at sorted positions inv_order[t*k + s] (the inverse
    # permutation, by a second argsort).
    slot_of_sorted = (sorted_e * cap + pos).clamp(0, e * cap - 1)
    slot_out = _gather_rows(out_b, slot_of_sorted) * keep[..., None].to(cfg.dtype)
    inv_order = torch.argsort(order, dim=-1)  # [g, tg*k]
    per_slot = _gather_rows(slot_out, inv_order).reshape(g, tg, k, d)
    out = torch.einsum("gtkd,gtk->gtd", per_slot, top_w.reshape(g, tg, k))

    if m.n_shared:
        out = out + swiglu(p.shared, xf.reshape(1, t, d), cfg).reshape(g, tg, d)
    return out.reshape(b, s, d), aux.float()
