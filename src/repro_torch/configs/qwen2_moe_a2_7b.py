"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    moe=MoEConfig(
        n_experts=60, top_k=4, d_expert=1408, n_shared=4, d_shared=5632,
        every_k_layers=1,
    ),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    max_seq_len=131_072,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=512, max_seq_len=128, dtype=torch.float32,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=2,
                      d_shared=64, every_k_layers=1),
    )
