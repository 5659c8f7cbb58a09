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

from repro_torch.models.layers import (fsdp_dims, fsdp_matmul, grad_like, mesh_of, on_shards,
                                       with_logical)
from repro_torch.models.mlp import swiglu, swiglu_specs
from repro_torch.models.module import ParamSpec
from repro_torch.sharding import policy


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


def _dispatch_groups(t: int) -> int:
    """Tokens are dispatched within data-parallel groups, so the gathers are
    batched over a sharded leading dim; each group has its own capacity, as
    real EP systems provision buffers. One group without an active mesh."""
    g = policy.active_dp_size()
    return g if (g > 1 and t % g == 0) else 1


def _expert_ffn(eb, p, cfg):
    """The experts' SwiGLU of ``eb`` [g, e, cap, d], batched over groups and
    experts. On a mesh, on each rank's groups and experts: their experts
    laid out like ``eb``'s (expert parallelism when the count divides the
    model axis) and, where the experts are not, their ``expert_mlp`` dim
    sharded (tensor parallelism, the output a partial sum over it). The
    weights are gathered over their embed dim (FSDP) where ``eb``'s groups
    are split over its axes; where they are not (a batch too small to split,
    as :func:`repro_torch.models.layers.fsdp_matmul`), the weights stay
    where they are, ``eb`` is sliced on ``d``, the input products'
    partial sums are all-reduced and the output is split on ``d``."""
    mesh = mesh_of(eb)
    ins = out = None
    fsdp = ()
    if mesh is not None:
        from torch.distributed.tensor import Partial, Shard

        g, e, _cap, _d = eb.shape
        rows, experts, ffn = policy.logical_spec((g, e, p.wi_gate.shape[-1]),
                                                 ("batch", "experts", "expert_mlp"))
        eb_pl = policy.placements(policy.Spec(rows, experts), mesh)
        w_in = policy.placements(policy.Spec(experts, None, ffn), mesh)
        w_out = policy.placements(policy.Spec(experts, ffn), mesh)
        out_pl = [Partial() if w.is_shard(2) else x for x, w in zip(eb_pl, w_in)]
        fsdp = fsdp_dims(p.wi_gate)
        if any(eb_pl[i].is_shard() for i in fsdp):  # groups split there: gather the weights
            fsdp = ()
        for i in fsdp:
            eb_pl, out_pl = _with(eb_pl, i, Shard(3)), _with(out_pl, i, Shard(3))
            w_in, w_out = _with(w_in, i, Shard(1)), _with(w_out, i, Shard(2))
        ins, out = (eb_pl, w_in, w_in, w_out), (out_pl,)

    def ffn(eb, wi_gate, wi_up, wo):
        gate = torch.einsum("gecd,edf->gecf", eb, wi_gate)
        up = torch.einsum("gecd,edf->gecf", eb, wi_up)
        for i in fsdp:  # partial sums over the embed shards
            import torch.distributed._functional_collectives as funcol

            gate, up = (funcol.all_reduce(t, "sum", (mesh, i)) for t in (gate, up))
        return torch.einsum("gecf,efd->gecd", F.silu(gate) * up, wo)

    dt = cfg.dtype
    return on_shards(ffn, mesh, ins, out)(eb, p.wi_gate.to(dt), p.wi_up.to(dt), p.wo.to(dt))


def _with(placements, i, placement):
    """``placements`` with mesh dim ``i``'s entry replaced."""
    return tuple(placement if j == i else pl for j, pl in enumerate(placements))


def _gather_rows(x, idx):
    """x: [g, n, d]; idx: [g, m] -> x[g, idx[g, j]]: [g, m, d]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def moe(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss f32 scalar).

    Tokens are dispatched within ``g`` groups (:func:`_dispatch_groups`),
    each with its own capacity: one per data-parallel shard of the active
    mesh, one on a single card."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k, e = m.top_k, m.n_experts
    g = _dispatch_groups(t)
    tg = t // g  # tokens per dispatch group
    cap = _capacity(tg, cfg)
    # The rows laid out by "batch" before they split into groups (DTensor may
    # have left them sharded over more mesh dims than the groups divide).
    x = with_logical(x, ("batch", None, None))
    xf = with_logical(x.reshape(g, tg, d), ("batch", None, None))
    dev = x.device

    # --- route -------------------------------------------------------- #
    logits = fsdp_matmul(xf, p.router.to(cfg.dtype))
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
    # EP constraint only when the expert count divides the model axis.
    eb = with_logical(eb, ("batch", "experts", None, None))

    # --- expert SwiGLU (batched over groups and experts) --------------- #
    out_b = with_logical(_expert_ffn(eb, p, cfg), ("batch", "experts", None, None))
    out_b = out_b.reshape(g, e * cap, d)

    # --- combine (gather-only) ------------------------------------------ #
    # Sorted slot j reads buffer row sorted_e[j]*cap + pos[j]; token t's k
    # slots sit at sorted positions inv_order[t*k + s] (the inverse
    # permutation, by a second argsort).
    slot_of_sorted = (sorted_e * cap + pos).clamp(0, e * cap - 1)
    slot_out = _gather_rows(out_b, slot_of_sorted) * keep[..., None].to(cfg.dtype)
    inv_order = torch.argsort(order, dim=-1)  # [g, tg*k]
    per_slot = _gather_rows(slot_out, inv_order).reshape(g, tg, k, d)
    out = torch.einsum("gtkd,gtk->gtd", per_slot, top_w.reshape(g, tg, k))
    out = with_logical(out, ("batch", None, None))

    if m.n_shared:
        out = out + swiglu(p.shared, xf.reshape(1, t, d), cfg).reshape(g, tg, d)
    return grad_like(out.reshape(b, s, d)), aux.float()
