"""Checkpoints in the JAX package's on-disk format (numpy arrays only)."""
from repro_torch.ckpt.checkpoint import (
    DEFAULT_RETAIN,
    SAVE_THREAD_PREFIX,
    CheckpointCorruptError,
    CheckpointManager,
    latest_step,
    quarantine_step,
    restore_pytree,
    restore_pytree_with_fallback,
    save_pytree,
)

__all__ = [
    "save_pytree",
    "restore_pytree",
    "restore_pytree_with_fallback",
    "latest_step",
    "quarantine_step",
    "CheckpointManager",
    "CheckpointCorruptError",
    "DEFAULT_RETAIN",
    "SAVE_THREAD_PREFIX",
]
