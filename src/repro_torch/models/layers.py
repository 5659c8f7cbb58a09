"""Basic layers: norms, rotary embeddings, token embedding, logits head.

Each function takes its parameters as a :class:`SpecModule` built from the
matching ``*_specs`` dict, and computes as the JAX package's
``models/layers.py`` does: norms in f32, RoPE angles in f32.
"""
from __future__ import annotations

import torch

from repro_torch.models.module import ParamSpec


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
    return p.tokens[tokens].to(cfg.dtype) * embed_scale(cfg)


def logits_head(p, x, cfg):
    if cfg.tie_embeddings:
        return x @ p.tokens.to(cfg.dtype).T
    return x @ p.unembed.to(cfg.dtype)


# --------------------------------------------------------------------- #
# Learned positional embedding (whisper decoder/encoder)
# --------------------------------------------------------------------- #
def learned_pos_specs(n_positions: int, dim: int) -> dict:
    return {"pos": ParamSpec((n_positions, dim), (None, "embed"), init="small")}


def learned_pos(p, positions, dtype):
    return p.pos[positions].to(dtype)
