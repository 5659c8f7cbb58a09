"""Architecture registry: ``--arch <id>`` resolution (the ten published
LM configurations of the JAX package, with torch dtypes)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    SHAPES,
    EncoderConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
)

_ARCH_MODULES: Dict[str, str] = {
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba15_large_398b",
}

ARCHS: List[str] = list(_ARCH_MODULES)

# long_500k needs sub-quadratic attention; the dry-run runs it only for the
# SSM, hybrid and sliding-window archs.
LONG_CONTEXT_ARCHS = {"mamba2-130m", "jamba-1.5-large-398b", "gemma3-27b"}


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(_ARCH_MODULES[name]).smoke_config()


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped long_500k cells excluded by
    default."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES.values():
            if (
                shape.name == "long_500k"
                and arch not in LONG_CONTEXT_ARCHS
                and not include_skipped
            ):
                continue
            out.append((arch, shape.name))
    return out


__all__ = [
    "ARCHS",
    "LONG_CONTEXT_ARCHS",
    "cells",
    "SHAPES",
    "EncoderConfig",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "SSMConfig",
    "get_config",
    "get_smoke_config",
]
