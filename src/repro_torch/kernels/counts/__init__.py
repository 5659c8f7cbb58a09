"""Partial-counts kernel (``csrc/counts.cu``) and its plain PyTorch version;
its launch plan is :func:`repro_torch.kernels.plan.counts_launch_plan`."""
from repro_torch.kernels.counts.ops import partial_counts_op, partial_counts_plain

__all__ = ["partial_counts_op", "partial_counts_plain"]
