"""whisper-small [audio]: enc-dec 12L d_model=768 12H d_ff=3072 vocab=51865
— conv frontend STUB (the caller provides precomputed frame embeddings
[B, 1500, 768]). LayerNorm + GELU + learned positions (no RoPE).
[arXiv:2212.04356; unverified]

Deviation (documented): real Whisper caps decoder positions at 448; the
assigned decode shapes need 32k, so the learned position table is extended.
long_500k is skipped (enc-dec with fixed 1500-frame source; full attention).
"""
import dataclasses

import torch

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
    cross_attn_every=1,  # every decoder layer cross-attends the encoder
    norm_type="layer",
    use_rope=False,
    mlp_type="gelu",
    tie_embeddings=True,
    max_seq_len=32_768,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=128, dtype=torch.float32,
        encoder=EncoderConfig(n_layers=2, n_frames=12),
    )
