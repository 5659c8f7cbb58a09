"""The partial-counts kernel of the distributed engine: CUDA wrapper and plain
version.

:func:`partial_counts_op` launches ``csrc/counts.cu`` for CUDA tensors and
runs :func:`partial_counts_plain` for CPU tensors; it never falls back from
one to the other. For meta tensors (the dry-run's traced sweep) it returns
the kernel's output shape. :func:`partial_counts_plain` transcribes the JAX
package's oracle (``repro/kernels/counts/ref.py``): per row, the suffix
counts over the LOCAL neighbour-slot shard

    cnt[r, i] = #{j : x[r, j] >= ext[r] + i + 1},  i in [0, cand)

the payload the distributed engine sums over the slot shards before its
feasibility argmax. Unlike the h-index kernels, ``cand`` is not clamped
to the width: a slot shard's counts are only one term of the sum.

:func:`~repro_torch.kernels.plan.counts_launch_plan` decides how a shard
is launched (the width class's path, block size, grid, cluster, shared
memory and rows per block); the C entry point only launches what it is
given, so the CPU tests reach every rule.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.plan import (CountsPlan, checked_plan, counts_launch_plan, launch,
                                      placement)

# The plain version materializes at most this many [row, slot, candidate]
# compares at a time (rows and candidates are chunked), so hub widths stay
# within memory.
_PLAIN_CHUNK = 1 << 27

# kcore_partial_counts' own arguments; the plan and the stream follow.
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, ext, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # rows, width, cand
)


def partial_counts_plain(x: torch.Tensor, ext: torch.Tensor, *, cand: int) -> torch.Tensor:
    """Plain PyTorch suffix counts. ``x``: [rows, width] (-1 pad), ``ext``:
    [rows]; returns [rows, cand] int32."""
    rows, width = x.shape
    cand = int(cand)
    x = x.to(torch.int32)
    ext = ext.to(torch.int32)
    out = torch.empty(rows, cand, dtype=torch.int32, device=x.device)
    w = max(width, 1)
    c_step = max(1, min(cand, _PLAIN_CHUNK // w))
    r_step = max(1, _PLAIN_CHUNK // (w * c_step))
    for lo in range(0, rows, r_step):
        xs, es = x[lo : lo + r_step], ext[lo : lo + r_step]
        for c_lo in range(0, cand, c_step):
            c_hi = min(cand, c_lo + c_step)
            i = torch.arange(c_lo + 1, c_hi + 1, dtype=torch.int32, device=x.device)
            thr = es[:, None] + i[None, :]  # [r, chunk]
            out[lo : lo + r_step, c_lo:c_hi] = (
                xs[:, :, None] >= thr[:, None, :]).sum(dim=1, dtype=torch.int32)
    return out


def partial_counts_op(x: torch.Tensor, ext: torch.Tensor, *, cand: int,
                      plan: Optional[CountsPlan] = None) -> torch.Tensor:
    """Suffix counts of one slot shard of a bucket: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    Args:
      x: [rows, w_local] int32 gathered neighbour estimates, pad slots -1.
      ext: [rows] int32 external information.
      cand: candidate window (>= 1; not clamped to ``w_local``).
      plan: the kernel's launch plan; default ``counts_launch_plan(rows,
        w_local, cand)``. A given plan must be one that function makes for
        these shapes (with its path and cluster forced): tests and
        ``chip_smoke.py`` pass one to reach every path.
    Returns:
      [rows, cand] int32 counts, exactly ``rows`` rows (no padding).

    Every kernel launch adds one to ``partial_counts_op.launches`` (and to the
    launching thread's entry of ``partial_counts_op.launches_by_thread``).
    """
    if x.dim() != 2 or ext.shape != (x.shape[0],):
        raise ValueError(f"partial_counts_op: x {tuple(x.shape)} / ext "
                         f"{tuple(ext.shape)} must be [rows, width] / [rows]")
    if int(cand) < 1:
        raise ValueError(f"partial_counts_op: cand {cand} must be >= 1")
    if x.dtype != torch.int32 or ext.dtype != torch.int32:
        raise TypeError(f"partial_counts_op: x {x.dtype} / ext {ext.dtype} must be int32")
    rows, width = x.shape
    plan = checked_plan("partial_counts_op", plan, counts_launch_plan, rows, width, cand)
    where = placement("partial_counts_op", (x, ext), meta=True)
    if where == "cpu":
        return partial_counts_plain(x, ext, cand=cand)
    out = torch.empty(rows, int(cand), dtype=torch.int32, device=x.device)
    if where == "meta":
        # The kernel's shape function, for a traced dry-run: a meta tensor
        # has no data. The tally prices what the kernel would do.
        _record(x, out)
        return out
    launch(partial_counts_op, "counts", "kcore_partial_counts", _ARGTYPES,
           (x.data_ptr(), ext.data_ptr(), out.data_ptr(), rows, width, int(cand)),
           plan, x.device)
    return out


def _record(x: torch.Tensor, out: torch.Tensor) -> None:
    """Charge the kernel's work to an active :class:`~repro_torch.roofline.
    tally.Tally` (its meta shape function does none of it through aten): the
    slots and ext read once, the counts written once, one int32 op per
    slot."""
    from repro_torch.roofline.tally import record_kernel

    rows = x.shape[0]
    record_kernel("partial_counts", read_bytes=x.numel() * 4 + rows * 4,
                  write_bytes=out.numel() * 4, int_ops=x.numel())


partial_counts_op.launches = 0
partial_counts_op.launches_by_thread = {}
