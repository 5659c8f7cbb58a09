"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, 8 experts top-2. [hf:xai-org/grok-1; unverified]

bf16 parameters, Adafactor and full remat: the published training setup
of the reference configuration (serving reads only the parameter dtype)."""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768, every_k_layers=1),
    rope_theta=10_000.0,
    tie_embeddings=False,
    max_seq_len=8_192,
    optimizer="adafactor",
    remat="full",
    param_dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=128, dtype=torch.float32,
        remat="none",
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128, every_k_layers=1),
    )
