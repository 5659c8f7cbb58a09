"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]

vocab 49155 is not divisible by any mesh axis; padded to 49408 (x256) for
model-axis sharding, pad logits masked in the loss (see ModelConfig)."""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49_155,
    rope_theta=10_000.0,
    tie_embeddings=True,
    max_seq_len=131_072,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=515, max_seq_len=128, dtype=torch.float32,
    )
