"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — partial RoPE, SwiGLU, GQA. [arXiv:2412.08905; hf]"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    rope_theta=10_000.0,
    rope_fraction=0.75,
    tie_embeddings=True,
    max_seq_len=131_072,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=128, dtype=torch.float32,
    )
