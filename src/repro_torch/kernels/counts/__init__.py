"""Partial-counts kernel (``csrc/counts.cu``) and its plain PyTorch version."""
from repro_torch.kernels.counts.ops import partial_counts_op, partial_counts_plain

__all__ = ["partial_counts_op", "partial_counts_plain"]
