"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    qk_norm=True,
    post_norms=True,
    sliding_window=1024,
    global_every=6,  # 5 local : 1 global
    rope_theta=10_000.0,
    rope_global_theta=1_000_000.0,
    tie_embeddings=True,
    max_seq_len=131_072,
    remat="full",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=8, max_seq_len=128,
        dtype=torch.float32, remat="none",
    )
