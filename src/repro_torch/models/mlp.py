"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.module import ParamSpec


def swiglu_specs(d_model: int, d_ff: int, param_dtype) -> dict:
    return {
        "wi_gate": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype=param_dtype),
        "wi_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype=param_dtype),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed"), dtype=param_dtype),
    }


def swiglu(p, x, cfg):
    gate = x @ p.wi_gate.to(cfg.dtype)
    up = x @ p.wi_up.to(cfg.dtype)
    return (F.silu(gate) * up) @ p.wo.to(cfg.dtype)


def gelu_mlp_specs(d_model: int, d_ff: int, param_dtype) -> dict:
    return {
        "wi": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype=param_dtype),
        "bi": ParamSpec((d_ff,), ("mlp",), init="zeros", dtype=param_dtype),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed"), dtype=param_dtype),
        "bo": ParamSpec((d_model,), (None,), init="zeros", dtype=param_dtype),
    }


def gelu_mlp(p, x, cfg):
    h = x @ p.wi.to(cfg.dtype)
    # jax.nn.gelu defaults to the tanh approximation.
    h = F.gelu(h + p.bi.to(cfg.dtype), approximate="tanh")
    return h @ p.wo.to(cfg.dtype) + p.bo.to(cfg.dtype)
