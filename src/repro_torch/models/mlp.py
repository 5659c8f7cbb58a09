"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.layers import fsdp_matmul, with_logical
from repro_torch.models.module import ParamSpec


def swiglu_specs(d_model: int, d_ff: int, param_dtype) -> dict:
    return {
        "wi_gate": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype=param_dtype),
        "wi_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype=param_dtype),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed"), dtype=param_dtype),
    }


def swiglu(p, x, cfg):
    gate = fsdp_matmul(x, p.wi_gate.to(cfg.dtype))
    up = fsdp_matmul(x, p.wi_up.to(cfg.dtype))
    h = with_logical(F.silu(gate) * up, ("batch", None, "mlp"))
    return with_logical(fsdp_matmul(h, p.wo.to(cfg.dtype)), ("batch", None, None))


def gelu_mlp_specs(d_model: int, d_ff: int, param_dtype) -> dict:
    return {
        "wi": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype=param_dtype),
        "bi": ParamSpec((d_ff,), ("mlp",), init="zeros", dtype=param_dtype),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed"), dtype=param_dtype),
        "bo": ParamSpec((d_model,), (None,), init="zeros", dtype=param_dtype),
    }


def gelu_mlp(p, x, cfg):
    h = fsdp_matmul(x, p.wi.to(cfg.dtype))
    # jax.nn.gelu defaults to the tanh approximation.
    h = F.gelu(h + p.bi.to(cfg.dtype), approximate="tanh")
    h = with_logical(h, ("batch", None, "mlp"))
    return fsdp_matmul(h, p.wo.to(cfg.dtype)) + p.bo.to(cfg.dtype)
