"""Basic layers: norms, rotary embeddings, token embedding, logits head,
and the sharding helpers.

Each function takes its parameters as a :class:`SpecModule` built from the
matching ``*_specs`` dict, and computes as the JAX package's
``models/layers.py`` does: norms in f32, RoPE angles in f32.

:func:`with_logical` is the reference's activation constraint by logical
axes: a no-op without an active mesh (one card, the CPU tests), a
redistribution of a DTensor on one (the dry-run); the other helpers lay
out what the dry-run's DTensors need beyond the reference's constraints.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.module import ParamSpec
from repro_torch.sharding import policy


# --------------------------------------------------------------------- #
# Sharding constraint helpers (no-ops without an active mesh)
# --------------------------------------------------------------------- #
def with_logical(x, axes):
    """Constraint by LOGICAL axis names, resolved against the active mesh
    with divisibility fallback (:func:`repro_torch.sharding.policy.
    logical_spec`): a DTensor is redistributed to the spec's placements on
    its mesh; a plain tensor, or any tensor without an active mesh, is
    returned as it is."""
    if not policy.mesh_active() or not _is_dtensor(x):
        return x
    target = policy.placements(policy.logical_spec(x.shape, axes), x.device_mesh)
    return x if tuple(x.placements) == target else x.redistribute(x.device_mesh, target)


def fsdp_gather(w):
    """A weight as a product uses it: on a mesh, gathered over the mesh axes
    the "embed" rule shards parameters on (FSDP / ZeRO-3: the weight whole
    for the product, its gradient reduce-scattered back by the gather's
    backward), its other shards (tensor parallelism) kept. Without an
    active mesh, or for a plain tensor, ``w`` as it is."""
    if not policy.mesh_active() or not _is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    fsdp = fsdp_dims(w)
    target = [Replicate() if i in fsdp else pl for i, pl in enumerate(w.placements)]
    return w if list(w.placements) == target else w.redistribute(w.device_mesh, target)


def fsdp_dims(w) -> tuple:
    """The mesh dims over which the "embed" rule shards the DTensor ``w``."""
    fsdp_axes = policy.active_rules().get("embed") or ()
    return tuple(i for i, (name, pl) in enumerate(zip(w.device_mesh.mesh_dim_names, w.placements))
                 if pl.is_shard() and name in fsdp_axes)


def fsdp_matmul(x, w):
    """``x @ w`` for a weight ``w`` [K, N] laid out by the policy.

    On a mesh, ``w`` is gathered over the FSDP axes that shard it
    (:func:`fsdp_gather`), as GSPMD does, where ``x``'s rows divide over
    them (train, prefill, a decode batch split over "data"). Where they do
    not (a batch the policy leaves unsplit there, such as long-context
    decode's one row), every rank of such an axis computes the same rows, so
    ``w`` stays where the policy puts it: on its contracted dim ``x`` is
    sliced locally and the partial products are all-reduced, on its output
    dim the output is gathered; a partial sum on any other mesh dim is
    reduced too, in the product's dtype, once. Without an active mesh, or
    for a plain ``w``, ``x @ w``."""
    if not policy.mesh_active() or not _is_dtensor(w):
        return x @ w
    from torch.distributed.tensor import Replicate, Shard

    mesh, fsdp = w.device_mesh, fsdp_dims(w)
    if not _is_dtensor(x):
        x = _replicated(x, mesh)
    if (x.numel() // x.shape[-1]) % math.prod(mesh.size(i) for i in fsdp) == 0 or any(
            w.placements[i].dim == 1 and not x.placements[i].is_replicate() for i in fsdp):
        return x @ fsdp_gather(w)
    # (A partial sum on another mesh dim is reduced first: DTensor would
    # gather the weight rather than multiply it.)
    xp = [Shard(x.ndim - 1) if i in fsdp and w.placements[i].dim == 0
          else Replicate() if p.is_partial() else p for i, p in enumerate(x.placements)]
    out = as_layout(x, mesh, xp) @ w
    return as_layout(out, mesh, [Replicate() if i in fsdp or p.is_partial() else p
                                 for i, p in enumerate(out.placements)])


def whole_units(x, n_units: int, name: str):
    """``x`` [B, ..., n_units * width] laid out so that its last dim splits
    into whole units (heads): on a mesh, rows over the batch axes and the
    last dim over the mesh axes the unit count divides over (DTensor cannot
    unflatten a dim sharded across unit boundaries), its gradient laid out
    the same. Without an active mesh, ``x`` as it is."""
    if not policy.mesh_active() or not _is_dtensor(x):
        return x
    spec = policy.logical_spec((x.shape[0], n_units), ("batch", name))
    target = policy.placements(policy.Spec(spec[0], *(None,) * (x.ndim - 2), spec[1]),
                               x.device_mesh)
    if tuple(x.placements) != target:
        x = x.redistribute(x.device_mesh, target)
    return grad_like(x)


def grad_like(x):
    """``x``; on a mesh, with its gradient laid out as ``x`` is. (DTensor's
    backward may hand a tensor a gradient in another layout, and the
    backward of a view that merges or splits a sharded dim cannot always
    take it.)"""
    if not policy.mesh_active() or not _is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor

    # from_local(to_local(x)) is x, and lays x's gradient out as x.
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def distribute_logical(x, axes):
    """:func:`with_logical` for a tensor made inside the model (positions,
    masks' sources): under an active ``DeviceMesh`` a plain tensor becomes a
    DTensor replicated on it, then laid out by ``axes`` (each rank keeps its
    own slice, no collective); without one, ``x`` as it is."""
    mesh = policy.active_device_mesh()
    if mesh is None:
        return x
    if not _is_dtensor(x):
        x = _replicated(x, mesh)
    return with_logical(x, axes)


def replicate_for(op: str, site: str, x):
    """``x`` replicated over its mesh when it is a sharded DTensor, for an op
    (``op``, at ``site``) that DTensor cannot run on its layout; the site is
    noted in the active mesh's log. Otherwise ``x`` as it is."""
    if not policy.mesh_active() or not _is_dtensor(x):
        return x
    if all(p.is_replicate() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    log = policy.active_log()
    if log is not None:
        log.note_op(op, site)
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def on_shards(fn, mesh, in_placements=None, out_placements=None):
    """``fn``, a function of plain tensors, as a function of DTensors on
    ``mesh``: each argument is laid out by its entry of ``in_placements``
    (a plain tensor taken as replicated; ``None`` for a non-tensor), ``fn``
    runs on this rank's local shards, and each result (a tensor, or a tuple
    of them) becomes a DTensor with its entry of ``out_placements``, one
    entry per result. An argument replicated on a mesh dim over which a
    result is split (sharded or partial) gets its gradient summed over that
    dim, since each rank's part of the work adds its share. With ``mesh``
    ``None`` (one card, the CPU), ``fn`` itself: the same code on the whole
    tensors."""
    if mesh is None:
        return fn
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    outs = tuple(tuple(o) for o in out_placements)
    split = [any(not o[i].is_replicate() for o in outs) for i in range(mesh.ndim)]
    ins = tuple(None if pl is None else tuple(pl) for pl in in_placements)
    grads = tuple(None if pl is None else
                  tuple(Partial() if cut and p.is_replicate() else p for p, cut in zip(pl, split))
                  for pl in ins)
    mapped = local_map(fn, out_placements=outs, in_placements=ins, in_grad_placements=grads,
                       device_mesh=mesh, redistribute_inputs=True)

    def run(*args):
        return mapped(*(_replicated(a, mesh) if isinstance(a, torch.Tensor) and not _is_dtensor(a)
                        else a for a in args))

    return run


def shard_start(shape, mesh, placements, dim: int) -> int:
    """The global index of this rank's first entry along ``dim`` of a
    tensor of ``shape`` laid out by ``placements`` on ``mesh`` (0 without a
    mesh)."""
    if mesh is None:
        return 0
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(shape, mesh, placements)[1][dim]


def as_layout(t, mesh, placements):
    """``t`` as a DTensor on ``mesh`` laid out by ``placements`` (a plain
    ``t`` taken as replicated)."""
    if not _is_dtensor(t):
        t = _replicated(t, mesh)
    placements = tuple(placements)
    return t if tuple(t.placements) == placements else t.redistribute(mesh, placements)


def mesh_of(t):
    """The ``DeviceMesh`` of a DTensor, ``None`` for a plain tensor."""
    return t.device_mesh if _is_dtensor(t) else None


def _is_dtensor(t) -> bool:
    return hasattr(t, "device_mesh")


def _replicated(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


# --------------------------------------------------------------------- #
# RMSNorm / LayerNorm
# --------------------------------------------------------------------- #
def rmsnorm_specs(dim: int) -> dict:
    return {"scale": ParamSpec((dim,), (None,), init="ones")}


def rmsnorm(p, x, eps: float = 1e-6):
    dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(dtype)


def layernorm_specs(dim: int) -> dict:
    return {
        "scale": ParamSpec((dim,), (None,), init="ones"),
        "bias": ParamSpec((dim,), (None,), init="zeros"),
    }


def layernorm(p, x, eps: float = 1e-6):
    dtype = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(dtype)


def norm_specs(cfg) -> dict:
    return layernorm_specs(cfg.d_model) if cfg.norm_type == "layer" else rmsnorm_specs(cfg.d_model)


def norm(p, x, cfg):
    fn = layernorm if cfg.norm_type == "layer" else rmsnorm
    return fn(p, x, cfg.norm_eps)


# --------------------------------------------------------------------- #
# Rotary position embedding
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, fraction: float, theta: float, device=None):
    rot_dim = int(head_dim * fraction) // 2 * 2
    exponents = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exponents), rot_dim


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: [B, S, H, D]; positions: [B, S] integer.

    The rotation runs in f32 (``x1 * cos`` promotes) and is cast back."""
    inv, rot_dim = rope_frequencies(x.shape[-1], fraction, theta, x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., None].float() * inv  # [B, S, rot/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), xp], dim=-1)


# --------------------------------------------------------------------- #
# Token embedding / logits head
# --------------------------------------------------------------------- #
def embedding_specs(cfg) -> dict:
    specs = {
        "tokens": ParamSpec(
            (cfg.vocab_padded, cfg.d_model), ("vocab", "embed"), init="embed",
            scale=1.0, dtype=cfg.param_dtype,
        )
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec(
            (cfg.d_model, cfg.vocab_padded), ("embed", "vocab"), init="small",
            dtype=cfg.param_dtype,
        )
    return specs


def embed_scale(cfg) -> float:
    """``sqrt(d_model)`` computed and rounded in the activation dtype, as
    the reference's ``jnp.asarray(d_model, dtype) ** 0.5`` (in bf16, 2048
    gives 45.25)."""
    return float(torch.tensor(cfg.d_model, dtype=cfg.dtype) ** 0.5)


def embed_tokens(p, tokens, cfg):
    # Gather, then cast: the same values as the reference's cast of the
    # whole table followed by the gather.
    table = p.tokens
    if _vocab_parallel(table, tokens):
        return _lookup_on_shards(table, tokens, cfg.dtype) * embed_scale(cfg)
    return fsdp_gather(table)[tokens].to(cfg.dtype) * embed_scale(cfg)


def _vocab_parallel(table, tokens) -> bool:
    """Whether a lookup runs on the table's vocab shards: on a mesh, for one
    position per row (a decode step) where the rows this rank returns are
    fewer than the table's local shard holds; the rows then cross the wire
    in place of the table."""
    if not policy.mesh_active() or not _is_dtensor(table) or tokens.shape[-1] != 1:
        return False
    if not any(pl.is_shard(0) for pl in table.placements):
        return False
    local = tokens.to_local() if _is_dtensor(tokens) else tokens
    return local.numel() < table.to_local().shape[0]


def _lookup_on_shards(table, tokens, dtype):
    """``table[tokens]`` in ``dtype``, vocab-parallel (as the loss's label
    gather, ``models/model.py::_label_logits``): each rank reads the tokens
    that fall in its vocab shard and zeroes the rest, and the rows sum over
    the vocab axes. The table is gathered over its FSDP axes where the
    tokens divide over them (as :func:`fsdp_matmul` gathers a weight);
    otherwise the rows stay split on the embed dim there."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    if not _is_dtensor(tokens):
        tokens = _replicated(tokens, mesh)
    if tokens.numel() % math.prod(mesh.size(i) for i in fsdp_dims(table)) == 0:
        table = fsdp_gather(table)
    t_pl = tuple(table.placements)
    tok_pl = tuple(Replicate() if t.is_shard() else p for t, p in zip(t_pl, tokens.placements))
    out_pl = tuple(Partial() if t.is_shard(0) else Shard(tokens.ndim) if t.is_shard(1) else p
                   for t, p in zip(t_pl, tok_pl))
    v0 = shard_start(table.shape, mesh, t_pl, 0)

    def lookup(table, tokens):
        idx = tokens - v0
        inside = (idx >= 0) & (idx < table.shape[0])
        rows = table[idx.clamp(0, table.shape[0] - 1)].to(dtype)
        return rows.masked_fill(~inside[..., None], 0)

    return on_shards(lookup, mesh, (t_pl, tok_pl), (out_pl,))(table, tokens)


def logits_head(p, x, cfg):
    if cfg.tie_embeddings:
        return fsdp_matmul(x, p.tokens.to(cfg.dtype).T)
    return fsdp_matmul(x, p.unembed.to(cfg.dtype))


# --------------------------------------------------------------------- #
# Learned positional embedding (whisper decoder/encoder)
# --------------------------------------------------------------------- #
def learned_pos_specs(n_positions: int, dim: int) -> dict:
    return {"pos": ParamSpec((n_positions, dim), (None, "embed"), init="small")}


def learned_pos(p, positions, dtype):
    return p.pos[positions].to(dtype)
