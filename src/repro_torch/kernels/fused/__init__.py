"""Fused sweep kernel (``csrc/fused.cu``), its launch plan and its plain
PyTorch version."""
from repro_torch.kernels.fused.ops import (FusedPlan, fused_launch_plan, fused_sweep_op,
                                           fused_sweep_plain)

__all__ = ["FusedPlan", "fused_launch_plan", "fused_sweep_op", "fused_sweep_plain"]
