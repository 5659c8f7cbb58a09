"""Fused sweep kernel (``csrc/fused.cu``) and its plain PyTorch version; its
launch plan is :func:`repro_torch.kernels.plan.fused_launch_plan`."""
from repro_torch.kernels.fused.ops import fused_sweep_op, fused_sweep_plain

__all__ = ["fused_sweep_op", "fused_sweep_plain"]
