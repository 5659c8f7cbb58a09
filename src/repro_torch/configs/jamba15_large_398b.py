"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536 — Mamba+attention 1:7 interleave, MoE 16 experts
top-2 every other layer. [arXiv:2403.19887; hf]

72 layers = 9 groups of 8 (1 attention + 7 mamba); MoE on odd layers.
398B total / ~94B active; bf16 parameters, Adafactor and full remat."""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65_536,
    attn_every=8,  # 1 attention layer per 8 (1:7)
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, every_k_layers=2),
    rope_theta=10_000.0,
    tie_embeddings=False,
    max_seq_len=262_144,
    optimizer="adafactor",
    remat="full",
    param_dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=1024, dtype=torch.float32,
        remat="none",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, every_k_layers=2),
    )
