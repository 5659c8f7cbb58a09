"""Partial-counts kernel (``csrc/counts.cu``), its launch plan and its plain
PyTorch version."""
from repro_torch.kernels.counts.ops import (CountsPlan, counts_launch_plan, partial_counts_op,
                                            partial_counts_plain)

__all__ = ["CountsPlan", "counts_launch_plan", "partial_counts_op", "partial_counts_plain"]
