"""Mamba2-style SSD (state-space duality) block, chunked matmul form.

The SSD algorithm of Mamba-2 (arXiv:2405.21060), as the JAX package's
``models/ssm.py`` computes it: the selective state-space recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t (x) x_t ,   y_t = C_t . h_t + D x_t

evaluated chunk-wise: within a chunk the quadratic (attention-like) matmul
form, across chunks only the [B, H, N, P] state is carried.

The causal depthwise conv (kernel ``d_conv``) is a shift-and-add over taps.
Decode keeps an O(1) cache: the SSD state plus the last ``d_conv - 1`` conv
inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (fsdp_matmul, mesh_of, on_shards, rmsnorm, whole_units,
                                       with_logical)
from repro_torch.models.module import ParamSpec
from repro_torch.sharding import policy


# --------------------------------------------------------------------- #
# Specs
# --------------------------------------------------------------------- #
def ssm_specs(cfg) -> dict:
    s, d, pd = cfg.ssm, cfg.d_model, cfg.param_dtype
    di, n, h = s.d_inner(d), s.d_state, s.n_heads(d)
    return {
        "wz": ParamSpec((d, di), ("embed", "inner"), dtype=pd),
        "wx": ParamSpec((d, di), ("embed", "inner"), dtype=pd),
        "wB": ParamSpec((d, n), ("embed", "state"), dtype=pd),
        "wC": ParamSpec((d, n), ("embed", "state"), dtype=pd),
        "wdt": ParamSpec((d, h), ("embed", None), dtype=pd),
        "conv_x": ParamSpec((s.d_conv, di), (None, "inner"), init="small", dtype=pd),
        "conv_B": ParamSpec((s.d_conv, n), (None, "state"), init="small", dtype=pd),
        "conv_C": ParamSpec((s.d_conv, n), (None, "state"), init="small", dtype=pd),
        "A_log": ParamSpec((h,), (None,), init="zeros", dtype=torch.float32),
        "dt_bias": ParamSpec((h,), (None,), init="zeros", dtype=torch.float32),
        "D": ParamSpec((h,), (None,), init="ones", dtype=torch.float32),
        "norm": {"scale": ParamSpec((di,), ("inner",), init="ones", dtype=pd)},
        "wo": ParamSpec((di, d), ("inner", "embed"), dtype=pd),
    }


def _causal_conv(x, w, tail=None):
    """Depthwise causal conv via shift-and-add. x: [B, S, C]; w: [K, C].

    ``tail``: [B, K-1, C] previous inputs (decode); returns the conv output
    of the same length as x."""
    k = w.shape[0]
    if tail is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, C]
    s = x.shape[1]
    return sum(xp[:, i:i + s, :] * w[i][None, None, :].to(x.dtype) for i in range(k))


def _project(p, x, cfg):
    dt = cfg.dtype
    z = fsdp_matmul(x, p.wz.to(dt))
    xs = fsdp_matmul(x, p.wx.to(dt))
    B = fsdp_matmul(x, p.wB.to(dt))
    C = fsdp_matmul(x, p.wC.to(dt))
    dtv = fsdp_matmul(x, p.wdt.to(dt))
    return z, xs, B, C, dtv


# --------------------------------------------------------------------- #
# Chunked SSD (prefill)
# --------------------------------------------------------------------- #
def _pad_seq(t, pad: int):
    """Zero-pad dim 1 (the sequence) by ``pad`` steps at the end."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)


def ssd_chunked(x, B, C, dt, A, chunk: int, h0=None):
    """x: [B,S,H,P]; B,C: [B,S,N]; dt: [B,S,H] (>0); A: [H] (<0).

    Returns (y [B,S,H,P], h_final [B,H,N,P])."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        # Zero-pad: dt=0 => decay exp(0)=1 and contribution dt*B*x = 0, so
        # padded steps are identity on the state; their outputs are dropped.
        x, B, C, dt = (_pad_seq(t, pad) for t in (x, B, C, dt))
    nc = (s + pad) // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    dtc = dt.reshape(b, nc, chunk, h)

    loga = dtc * A[None, None, None, :]  # [b, nc, L, h], negative
    cum = torch.cumsum(loga, dim=2)  # inclusive within-chunk cumsum

    hprev = h0 if h0 is not None else torch.zeros((b, h, n, p), dtype=torch.float32,
                                                  device=x.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xc_, Bc_, Cc_, dtc_, cum_ = xc[:, c], Bc[:, c], Cc[:, c], dtc[:, c], cum[:, c]
        # Intra-chunk quadratic form (per head decay mask).
        cb = torch.einsum("bin,bjn->bij", Cc_, Bc_).float()  # [b,L,L]
        seg = cum_[:, :, None, :] - cum_[:, None, :, :]  # [b,i,j,h]
        # Mask in log space BEFORE exp: above the diagonal seg > 0 and
        # exp(seg) overflows.
        seg = seg.masked_fill(~mask[None, :, :, None], float("-inf"))
        decay = torch.exp(seg)
        m = cb[:, :, :, None] * decay * dtc_[:, None, :, :]  # [b,i,j,h]
        y_intra = torch.einsum("bijh,bjhp->bihp", m.to(xc_.dtype), xc_)
        # Inter-chunk: contribution of the carried state.
        instate = torch.exp(cum_)  # [b,i,h]
        y_inter = torch.einsum(
            "bin,bhnp,bih->bihp", Cc_.float(), hprev, instate
        ).to(xc_.dtype)
        # New carried state.
        tail = torch.exp(cum_[:, -1:, :] - cum_)  # exp(cum_L - cum_j) [b,j,h]
        contrib = torch.einsum(
            "bjn,bjhp,bjh->bhnp", Bc_.float(), xc_.float(), (dtc_ * tail).float()
        )
        hprev = torch.exp(cum_[:, -1, :])[:, :, None, None] * hprev + contrib
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s + pad, h, p)[:, :s]
    return y, hprev


def _rows_and_heads(fn, x, n_heads: int, ins, outs):
    """``fn`` on each rank's rows (batch) and SSM heads when ``x`` is a
    DTensor (the recurrence never mixes them), else ``fn`` itself. ``ins``
    and ``outs`` give each argument's and result's (row dim, head dim),
    ``None`` where it has none."""
    mesh = mesh_of(x)
    if mesh is None:
        return fn
    row, head = policy.logical_spec((x.shape[0], n_heads), ("batch", "inner"))

    def pl(dims):
        entries = [None] * (max(d for d in dims if d is not None) + 1)
        for d, entry in zip(dims, (row, head)):
            if d is not None:
                entries[d] = entry
        return policy.placements(policy.Spec(*entries), mesh)

    return on_shards(fn, mesh, [pl(d) for d in ins], [pl(d) for d in outs])


def _ssd(x, B, C, dt, A, chunk: int):
    """:func:`ssd_chunked`, on a mesh on each rank's rows and heads."""
    fn = _rows_and_heads(lambda *a: ssd_chunked(*a, chunk=chunk), x, x.shape[2],
                         ins=((0, 2), (0, None), (0, None), (0, 2), (None, 0)),
                         outs=((0, 2), (0, 1)))
    return fn(x, B, C, dt, A)


def _state_step(B0, xh, dt, A, h_prev, C0):
    """One recurrence step: (y [B, H, P] in f32, h [B, H, N, P])."""
    a = torch.exp(dt * A[None, :])  # [B, H]
    upd = torch.einsum("bn,bhp,bh->bhnp", B0.float(), xh.float(), dt)
    h = a[:, :, None, None] * h_prev + upd
    return torch.einsum("bn,bhnp->bhp", C0.float(), h), h


def ssd_sequential_ref(x, B, C, dt, A):
    """O(S) sequential oracle for tests (fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    hs = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        a = torch.exp(dt[:, t] * A[None, :])  # [b,h]
        upd = torch.einsum("bn,bhp,bh->bhnp", B[:, t].float(), x[:, t].float(), dt[:, t])
        hs = a[:, :, None, None] * hs + upd
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t].float(), hs))
    return torch.stack(ys, dim=1)  # [b,s,h,p]


# --------------------------------------------------------------------- #
# Block-level apply
# --------------------------------------------------------------------- #
def _split_heads(xs, cfg):
    b, L, di = xs.shape
    xs = whole_units(xs, di // cfg.ssm.head_dim, "inner")
    return xs.reshape(b, L, di // cfg.ssm.head_dim, cfg.ssm.head_dim)


def _dt(p, dtv):
    # softplus (its own threshold of 20) written out: DTensor has no rule for
    # softplus's backward. The clamp keeps exp finite where x > 20 is taken.
    x = dtv.float() + p.dt_bias[None, None, :]
    return torch.where(x > 20, x, torch.log1p(torch.exp(x.clamp(max=20))))


def ssm_block(p, x, cfg, return_cache: bool = False):
    """Full-sequence SSD block. x: [B, S, D] -> ([B, S, D], cache or None)."""
    s = cfg.ssm
    z, xs, B, C, dtv = _project(p, x, cfg)
    conv_in = {"x": xs, "B": B, "C": C}
    xs = F.silu(_causal_conv(xs, p.conv_x))
    B = F.silu(_causal_conv(B, p.conv_B))
    C = F.silu(_causal_conv(C, p.conv_C))
    xs = with_logical(xs, ("batch", None, "inner"))

    A = -torch.exp(p.A_log.float())
    xh = _split_heads(xs, cfg)
    y, h_final = _ssd(xh, B, C, _dt(p, dtv), A, chunk=min(s.chunk, x.shape[1]))
    y = y + p.D[None, None, :, None].to(y.dtype) * xh
    y = whole_units(y.reshape(z.shape), xh.shape[2], "inner")
    y = rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    out = with_logical(fsdp_matmul(y, p.wo.to(cfg.dtype)), ("batch", None, None))
    if not return_cache:
        return out, None
    k = s.d_conv - 1
    return out, {"h": h_final, "conv": {name: arr[:, -k:, :] for name, arr in conv_in.items()}}


def ssm_cache_specs(cfg, batch: int):
    """(shape, logical axes, dtype) of each leaf of an SSM layer's cache."""
    s = cfg.ssm
    di, n, h = s.d_inner(cfg.d_model), s.d_state, s.n_heads(cfg.d_model)
    k = s.d_conv - 1
    return {
        "h": ((batch, h, n, s.head_dim), ("cache_batch", None, "state", None), torch.float32),
        "conv": {
            "x": ((batch, k, di), ("cache_batch", None, "inner"), cfg.dtype),
            "B": ((batch, k, n), ("cache_batch", None, "state"), cfg.dtype),
            "C": ((batch, k, n), ("cache_batch", None, "state"), cfg.dtype),
        },
    }


def ssm_block_decode(p, x, cache, cfg):
    """One-token decode. x: [B, 1, D] -> (out [B, 1, D], new cache)."""
    z, xs, B, C, dtv = _project(p, x, cfg)
    conv_prev = cache["conv"]
    new_conv = {
        "x": torch.cat([conv_prev["x"][:, 1:], xs], dim=1),
        "B": torch.cat([conv_prev["B"][:, 1:], B], dim=1),
        "C": torch.cat([conv_prev["C"][:, 1:], C], dim=1),
    }
    xs = F.silu(_causal_conv(xs, p.conv_x, conv_prev["x"]))
    B = F.silu(_causal_conv(B, p.conv_B, conv_prev["B"]))
    C = F.silu(_causal_conv(C, p.conv_C, conv_prev["C"]))

    A = -torch.exp(p.A_log.float())
    dt = _dt(p, dtv)[:, 0]
    xh = _split_heads(xs, cfg)[:, 0]  # [B, H, P]
    step = _rows_and_heads(_state_step, xh, xh.shape[1],
                           ins=((0, None), (0, 1), (0, 1), (None, 0), (0, 1), (0, None)),
                           outs=((0, 1), (0, 1)))
    y, h = step(B[:, 0], xh, dt, A, cache["h"], C[:, 0])
    y = y.to(cfg.dtype)
    y = y + p.D[None, :, None].to(y.dtype) * xh
    y = whole_units(y.reshape(z.shape[0], 1, -1), xh.shape[1], "inner")
    y = rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    out = fsdp_matmul(y, p.wo.to(cfg.dtype))
    return out, {"h": h, "conv": new_conv}
