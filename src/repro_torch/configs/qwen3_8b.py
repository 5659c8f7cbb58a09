"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    max_seq_len=131_072,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=128, dtype=torch.float32,
    )
