"""Model configuration dataclasses of the port.

A copy of the JAX package's ``configs/base.py`` with torch dtypes: each
architecture file (``repro_torch/configs/<id>.py``) exports ``CONFIG`` (the
published configuration) and ``smoke_config()`` (a reduced same-family
variant for CPU tests); :mod:`repro_torch.configs` is the registry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN width
    n_shared: int = 0  # shared experts (qwen2-moe)
    d_shared: int = 0  # combined shared-expert FFN width
    every_k_layers: int = 1  # 1 = every layer; 2 = alternate (jamba)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec archs (whisper). The modality frontend is a
    stub: the caller provides precomputed frame embeddings."""

    n_layers: int
    n_frames: int  # fixed source length (whisper: 1500)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # phi4: partial rotary
    sliding_window: Optional[int] = None  # local attention window
    global_every: Optional[int] = None  # gemma3: 1 global per N layers
    rope_global_theta: Optional[float] = None  # gemma3 global layers

    # mixture of experts
    moe: Optional[MoEConfig] = None

    # state-space layers
    ssm: Optional[SSMConfig] = None
    attn_every: Optional[int] = None  # jamba: 1 attention layer per N

    # cross-attention (vlm) / enc-dec (audio)
    cross_attn_every: Optional[int] = None
    n_vision_tokens: int = 0
    encoder: Optional[EncoderConfig] = None

    # embeddings / norms
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    norm_type: str = "rms"  # rms | layer (whisper)
    use_rope: bool = True  # whisper: learned positions instead
    mlp_type: str = "swiglu"  # swiglu | gelu (whisper)
    post_norms: bool = False  # gemma3: post-attention/ffw norms
    max_seq_len: int = 131_072

    # numerics / runtime. `remat`, `optimizer` and `sharding_overrides` are
    # the training and mesh settings of the published configuration, kept as
    # metadata; serving reads none of them.
    dtype: Any = torch.bfloat16  # activations
    param_dtype: Any = torch.float32
    remat: str = "none"  # none | full | dots
    attention_impl: str = "auto"  # auto | full | chunked
    attn_chunk: int = 1024
    optimizer: str = "adamw"  # adamw | adafactor
    sharding_overrides: Tuple[Tuple[str, Any], ...] = ()

    # ---------------------------------------------------------------- #
    @property
    def vocab_padded(self) -> int:
        """Vocab padded to x256 (the reference pads for model-axis sharding);
        logits over the pad are masked before argmax and in the loss."""
        return int(math.ceil(self.vocab_size / 256) * 256)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def is_attn_layer(self, idx: int) -> bool:
        """Hybrid stacks: which layers are attention (rest are SSM)."""
        if self.ssm is None:
            return True
        if self.attn_every is None:
            return False  # pure SSM
        return idx % self.attn_every == self.attn_every // 2

    def is_global_layer(self, idx: int) -> bool:
        """Sliding-window stacks: which layers attend globally."""
        if self.sliding_window is None:
            return True
        if self.global_every is None:
            return False
        return idx % self.global_every == self.global_every - 1

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None:
            return False
        return idx % self.moe.every_k_layers == self.moe.every_k_layers - 1

    def is_cross_layer(self, idx: int) -> bool:
        if self.cross_attn_every is None:
            return False
        return idx % self.cross_attn_every == self.cross_attn_every - 1

    def param_count_estimate(self) -> int:
        """Exact parameter count of the port's model, built on ``meta``."""
        from repro_torch.models.model import CausalLM
        from repro_torch.models.module import count_params

        return count_params(CausalLM(self, device="meta"))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
