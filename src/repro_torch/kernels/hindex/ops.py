"""The h-index kernel (``engine="kernel"``): CUDA wrapper and plain version.

:func:`hindex_op` launches ``csrc/hindex.cu`` for a CUDA tensor and runs
:func:`hindex_plain` for a CPU tensor; it never falls back from one to the
other. :func:`hindex_plain` transcribes the JAX package's oracle
(``repro/kernels/hindex/ref.py``):

    out[r] = ext[r] + max{ i in [1, cand] : #{j : x[r, j] >= ext[r] + i} >= i }

(0 if no ``i`` is feasible), with ``cand`` clamped to ``[1, width]``.

The kernel launches the fused kernel's row paths by the fused kernel's
launch plan (:func:`~repro_torch.kernels.plan.fused_launch_plan`): a
sub-warp group per row up to 16 slots, a warp per row up to 1,024, a
shared-memory histogram per wider row (split over a cluster on tiles with
fewer rows than SMs), and the exact search when the bins exceed shared
memory.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.plan import (FusedPlan, checked_plan, fused_launch_plan, launch,
                                      placement)

# The plain version materializes at most this many [row, slot, candidate]
# compares at a time (rows and candidates are chunked), so hub widths stay
# within memory.
_PLAIN_CHUNK = 1 << 27

# kcore_hindex's own arguments; the plan and the stream follow.
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, ext, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # rows, width, cand
)


def hindex_plain(x: torch.Tensor, ext: torch.Tensor, *, cand: int) -> torch.Tensor:
    """Plain PyTorch h-index. ``x``: [rows, width] (-1 pad), ``ext``: [rows];
    returns [rows] int32."""
    rows, width = x.shape
    cand = int(min(max(int(cand), 1), width))
    x = x.to(torch.int32)
    ext = ext.to(torch.int32)
    out = torch.empty(rows, dtype=torch.int32, device=x.device)
    c_step = max(1, min(cand, _PLAIN_CHUNK // width))
    r_step = max(1, _PLAIN_CHUNK // (width * c_step))
    for lo in range(0, rows, r_step):
        xs, es = x[lo : lo + r_step], ext[lo : lo + r_step]
        best = torch.zeros_like(es)
        for c_lo in range(0, cand, c_step):
            i = torch.arange(c_lo + 1, min(cand, c_lo + c_step) + 1,
                             dtype=torch.int32, device=x.device)
            thr = es[:, None] + i[None, :]  # [r, chunk]
            cnt = (xs[:, :, None] >= thr[:, None, :]).sum(dim=1)  # [r, chunk]
            best = torch.maximum(best, torch.where(cnt >= i, i, 0).amax(dim=1))
        out[lo : lo + r_step] = es + best
    return out


def hindex_op(x: torch.Tensor, ext: torch.Tensor, *, cand: int,
              plan: Optional[FusedPlan] = None) -> torch.Tensor:
    """H-index of one padded bucket: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    Args:
      x: [rows, width] int32 (or int16, widened here) gathered neighbour
        estimates, pad slots -1.
      ext: [rows] int32 external information.
      cand: candidate window (degeneracy bound; clamped to ``[1, width]``).
      plan: the kernel's launch plan; default ``fused_launch_plan(rows,
        width, cand)``. A given plan must be one that function makes for
        these shapes (with its path and cluster forced), as for
        ``fused_sweep_op``.
    Returns:
      [rows] int32 new estimates.

    Every kernel launch adds one to ``hindex_op.launches`` (and to the
    launching thread's entry of ``hindex_op.launches_by_thread``).
    """
    if x.dim() != 2 or x.shape[1] < 1 or ext.shape != (x.shape[0],):
        raise ValueError(f"hindex_op: x {tuple(x.shape)} / ext {tuple(ext.shape)} "
                         f"must be [rows, width] / [rows]")
    if x.dtype == torch.int16:
        x = x.to(torch.int32)
    if x.dtype != torch.int32 or ext.dtype != torch.int32:
        raise TypeError(f"hindex_op: x {x.dtype} / ext {ext.dtype} must be int32")
    rows, width = x.shape
    plan = checked_plan("hindex_op", plan, fused_launch_plan, rows, width, cand)
    if placement("hindex_op", (x, ext)) == "cpu":
        return hindex_plain(x, ext, cand=cand)
    out = torch.empty(rows, dtype=torch.int32, device=x.device)
    launch(hindex_op, "hindex", "kcore_hindex", _ARGTYPES,
           (x.data_ptr(), ext.data_ptr(), out.data_ptr(), rows, width, int(cand)),
           plan, x.device)
    return out


hindex_op.launches = 0
hindex_op.launches_by_thread = {}
