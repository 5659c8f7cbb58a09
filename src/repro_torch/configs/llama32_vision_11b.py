"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — gated cross-attention image layers every 5th layer; the
vision frontend is a STUB (the caller provides precomputed patch
embeddings [B, 1600, d_model]). [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128_256,
    cross_attn_every=5,
    n_vision_tokens=1600,
    rope_theta=500_000.0,
    tie_embeddings=False,
    max_seq_len=131_072,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, n_vision_tokens=16, max_seq_len=128,
        dtype=torch.float32,
    )
