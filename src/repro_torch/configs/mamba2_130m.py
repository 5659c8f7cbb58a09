"""mamba2-130m [ssm]: 24L d_model=768 attn-free, vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,  # unused (attention-free); kept for dataclass completeness
    n_kv_heads=12,
    head_dim=64,
    d_ff=0,  # no FFN in mamba blocks
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    attn_every=None,  # pure SSM
    tie_embeddings=True,
    max_seq_len=1_048_576,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, vocab_size=512, max_seq_len=1024,
        dtype=torch.float32,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    )
