"""The fused sweep kernel (``engine="fused"``): CUDA wrapper and plain version.

:func:`fused_sweep_op` launches ``csrc/fused.cu`` for CUDA tensors and runs
:func:`fused_sweep_plain` for CPU tensors; it never falls back from one to
the other. :func:`fused_sweep_plain` transcribes the JAX package's
reference (``repro/kernels/fused/ref.py``): gather, h-index over the
candidate window, changed compare, dirty push.

One difference from the reference is deliberate: the push skips the
sentinel slot ``n``. Pad neighbours of a changed row would set
``dirty[n]``, a slot no reader ever looks at, and on the card every such
store would hit one address.

:func:`~repro_torch.kernels.plan.fused_launch_plan` decides how a bucket
is launched (the width class's path, block size, grid, cluster and shared
memory); the C entry point only launches what it is given, so the CPU tests
reach every rule.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.hindex.ops import hindex_plain
from repro_torch.kernels.plan import (FusedPlan, checked_plan, fused_launch_plan, launch,
                                      placement)

# kcore_fused_sweep's own arguments; the plan and the stream follow.
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int,                      # c, c_bytes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ext_pad, ids, neigh
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # est, changed, dirty
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # n, rows, width
    ctypes.c_int, ctypes.c_int,                         # cand, track_dirty
)


def fused_sweep_plain(
    c: torch.Tensor,
    ext_pad: torch.Tensor,
    ids: torch.Tensor,
    neigh: torch.Tensor,
    *,
    cand: int,
    track_dirty: bool = True,
    dirty: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch fused sweep; same contract as :func:`fused_sweep_op`."""
    sentinel = c.shape[0] - 1
    if dirty is None:
        dirty = torch.zeros(c.shape[0], dtype=torch.int8, device=c.device)
    gathered = c[neigh].to(torch.int32)
    ext_rows = ext_pad[ids]
    cur_rows = c[ids].to(torch.int32)
    est = hindex_plain(gathered, ext_rows, cand=cand)
    row_changed = (est != cur_rows) & (ids != sentinel)
    if track_dirty:
        hit = neigh[row_changed].reshape(-1)
        dirty[hit[hit != sentinel]] = 1
    return est, row_changed.to(torch.int32), dirty


def fused_sweep_op(
    c: torch.Tensor,
    ext_pad: torch.Tensor,
    ids: torch.Tensor,
    neigh: torch.Tensor,
    *,
    cand: int,
    track_dirty: bool = True,
    dirty: Optional[torch.Tensor] = None,
    plan: Optional[FusedPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused gather + h-index + dirty push for one bucket: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.

    Args:
      c: [n+1] int16 or int32 estimates, slot n = -1 (the sentinel).
      ext_pad: [n+1] int32 external information, slot n = 0.
      ids: [rows] int32 node ids (pad rows = n).
      neigh: [rows, width] int32 neighbour ids (pad slots = n).
      cand: candidate window (degeneracy bound; clamped to ``[1, width]``).
      track_dirty: push dirty bits to the neighbours of changed rows.
      dirty: optional [n+1] int8 buffer to push into (a sweep passes one
        buffer, zeroed once, to all its launches); a zeroed one is made
        when absent.
      plan: the kernel's launch plan; default ``fused_launch_plan(rows,
        width, cand)``. A given plan must be one that function makes for
        these shapes (with its path and cluster forced): tests and
        ``chip_smoke.py`` pass one to reach every path and to time one
        block per row against a cluster.
    Returns:
      ``(est [rows] int32, row_changed [rows] int32, dirty [n+1] int8)``.

    Every kernel launch adds one to ``fused_sweep_op.launches`` (and to the
    launching thread's entry of ``fused_sweep_op.launches_by_thread``).
    """
    n1 = c.shape[0]
    if (c.dim() != 1 or ext_pad.shape != (n1,) or neigh.dim() != 2
            or neigh.shape[1] < 1 or ids.shape != (neigh.shape[0],)
            or (dirty is not None and dirty.shape != (n1,))):
        raise ValueError(
            f"fused_sweep_op: c {tuple(c.shape)}, ext_pad {tuple(ext_pad.shape)}, "
            f"ids {tuple(ids.shape)}, neigh {tuple(neigh.shape)} must be "
            f"[n+1], [n+1], [rows], [rows, width]")
    if (c.dtype not in (torch.int16, torch.int32) or ext_pad.dtype != torch.int32
            or ids.dtype != torch.int32 or neigh.dtype != torch.int32
            or (dirty is not None and dirty.dtype != torch.int8)):
        raise TypeError("fused_sweep_op: c must be int16/int32, ext_pad/ids/"
                        "neigh int32, dirty int8")
    rows, width = neigh.shape
    plan = checked_plan("fused_sweep_op", plan, fused_launch_plan, rows, width, cand)
    tensors = [c, ext_pad, ids, neigh] + ([dirty] if dirty is not None else [])
    if placement("fused_sweep_op", tensors) == "cpu":
        return fused_sweep_plain(c, ext_pad, ids, neigh, cand=cand,
                                 track_dirty=track_dirty, dirty=dirty)
    if dirty is None:
        dirty = torch.zeros(n1, dtype=torch.int8, device=c.device)
    est = torch.empty(rows, dtype=torch.int32, device=c.device)
    changed = torch.empty(rows, dtype=torch.int32, device=c.device)
    launch(fused_sweep_op, "fused", "kcore_fused_sweep", _ARGTYPES,
           (c.data_ptr(), c.element_size(), ext_pad.data_ptr(), ids.data_ptr(),
            neigh.data_ptr(), est.data_ptr(), changed.data_ptr(), dirty.data_ptr(),
            n1 - 1, rows, width, int(cand), int(bool(track_dirty))), plan, c.device)
    return est, changed, dirty


fused_sweep_op.launches = 0
fused_sweep_op.launches_by_thread = {}
