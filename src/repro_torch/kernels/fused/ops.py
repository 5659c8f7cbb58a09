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

:func:`fused_launch_plan` decides how a bucket is launched (the width
class's path, block size, grid, cluster and shared memory); the C entry
point only launches what it is given, so the CPU tests reach every rule.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.hindex.ops import hindex_plain

_fn = None

# The launch plan's constants, for the H100 SXM: its SMs; the histogram
# bins that fit, beside the kernel's scratch ints (hist_common.cuh
# kHistScratch), in the 227 KB (232,448 bytes) of shared memory one block
# may take; the largest portable cluster; the paths' block sizes, each at
# most its kernel's __launch_bounds__ (hist_common.cuh kGroupBlock,
# hindex_common.cuh kThreadBlock and kRowBlock).
SMS = 132
HIST_SCRATCH = 64
MAX_BINS = 57_344
MAX_CLUSTER = 8
GROUP_BLOCK = 128
WARP_BLOCK = 256
SEARCH_BLOCK = 1024
PATHS = ("group", "warp", "hist", "search")  # fused.cu's enum Path, in order


class FusedPlan(NamedTuple):
    """How one bucket is launched: ``path`` (one of :data:`PATHS`),
    ``threads`` per block, ``blocks`` in the grid, ``cluster`` blocks per
    thread-block cluster (the blocks of one row on the hist path),
    ``smem_bytes`` of dynamic shared memory, and ``group``, the threads of
    one block that take one row."""

    path: str
    threads: int
    blocks: int
    cluster: int
    smem_bytes: int
    group: int


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


@functools.lru_cache(maxsize=4096)
def fused_launch_plan(rows: int, width: int, cand: int, *,
                      path: Optional[str] = None,
                      cluster: Optional[int] = None) -> FusedPlan:
    """The launch plan of ``csrc/fused.cu`` for a ``[rows, width]`` bucket
    with candidate window ``cand`` (a pure function of the shapes).

    Paths by width, with ``B = min(max(cand, 1), width)``:

    * ``group`` (width <= 16): 8 or 16 lanes per row, ``GROUP_BLOCK``
      threads a block, so a 10 k-row width-8 tile makes 670 blocks;
    * ``warp`` (width <= 1024): a warp per row, ``WARP_BLOCK`` threads;
    * ``hist`` (wider, ``B + 1 <= MAX_BINS``): a shared-memory histogram of
      ``B + 1`` bins per row; a tile with fewer rows than ``SMS`` splits
      each row over a cluster of up to ``MAX_CLUSTER`` blocks (while each
      block keeps at least 1,024 slots), so its rows reach every SM (on the
      H100 that beat one block a row 2-4x on tiles of 8 and 24 rows, and
      lost 8% on one of 192); 256-1,024 threads a block, about 8 slots a
      thread;
    * ``search`` (``B + 1 > MAX_BINS``): a block per row, the exact binary
      search (the bins would not fit in shared memory).

    ``path`` and ``cluster`` force a path (it must cover the width) and a
    hist cluster; the rest follows from them.
    """
    rows, width = int(rows), int(width)
    bound = min(max(int(cand), 1), width)
    if path is None:
        path = ("group" if width <= 16 else "warp" if width <= 1024
                else "hist" if bound + 1 <= MAX_BINS else "search")
    if cluster is not None and path != "hist":
        raise ValueError(f"fused_launch_plan: a cluster is only planned on the hist path, "
                         f"not {path!r}")
    if path == "group" and width <= 16:
        group = 8 if width <= 8 else 16
        return FusedPlan(path, GROUP_BLOCK, -(-rows * group // GROUP_BLOCK), 1, 0, group)
    if path == "warp" and width <= 1024:
        return FusedPlan(path, WARP_BLOCK, -(-rows * 32 // WARP_BLOCK), 1, 0, 32)
    if path == "hist" and bound + 1 <= MAX_BINS:
        if cluster is None:
            want = -(-SMS // max(rows, 1))
            cluster = 1
            while cluster < min(want, MAX_CLUSTER) and width // (2 * cluster) >= 1024:
                cluster *= 2
        if not 1 <= cluster <= MAX_CLUSTER:
            raise ValueError(f"fused_launch_plan: cluster {cluster} not in [1, {MAX_CLUSTER}]")
        share = -(-width // cluster)
        threads = min(1024, max(256, _next_pow2(-(-share // 8))))
        smem = (bound + 1 + HIST_SCRATCH) * 4
        return FusedPlan(path, threads, rows * cluster, cluster, smem, threads)
    if path == "search":
        return FusedPlan(path, SEARCH_BLOCK, rows, 1, 0, SEARCH_BLOCK)
    raise ValueError(f"fused_launch_plan: path {path!r} cannot take width {width} "
                     f"with cand {cand}")


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


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load

        fn = load("fused").kcore_fused_sweep
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int,                    # c, c_bytes
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ext_pad, ids, neigh
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # est, changed, dirty
            ctypes.c_int, ctypes.c_int, ctypes.c_int,          # n, rows, width
            ctypes.c_int, ctypes.c_int,                        # cand, track_dirty
            ctypes.c_int, ctypes.c_int, ctypes.c_int,          # path, threads, blocks
            ctypes.c_int, ctypes.c_int, ctypes.c_int,          # cluster, smem_bytes, group
            ctypes.c_void_p,                                   # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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

    Every kernel launch adds one to ``fused_sweep_op.launches``.
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
    if plan is None:
        plan = fused_launch_plan(rows, width, cand)
    elif plan != fused_launch_plan(rows, width, cand, path=plan.path,
                                   cluster=plan.cluster if plan.path == "hist" else None):
        raise ValueError(f"fused_sweep_op: {plan} is not a launch plan for "
                         f"[{rows}, {width}] rows with cand {cand}")
    tensors = [c, ext_pad, ids, neigh] + ([dirty] if dirty is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return fused_sweep_plain(c, ext_pad, ids, neigh, cand=cand,
                                 track_dirty=track_dirty, dirty=dirty)
    if c.device.type != "cuda" or any(t.device != c.device for t in tensors):
        raise ValueError("fused_sweep_op: all tensors must be on one CUDA "
                         "device (or all on the CPU)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_sweep_op: all tensors must be contiguous")
    if dirty is None:
        dirty = torch.zeros(n1, dtype=torch.int8, device=c.device)
    est = torch.empty(rows, dtype=torch.int32, device=c.device)
    changed = torch.empty(rows, dtype=torch.int32, device=c.device)
    if rows == 0:
        return est, changed, dirty
    stream = torch.cuda.current_stream(c.device).cuda_stream
    err = _kernel()(
        c.data_ptr(), c.element_size(), ext_pad.data_ptr(), ids.data_ptr(),
        neigh.data_ptr(), est.data_ptr(), changed.data_ptr(), dirty.data_ptr(),
        n1 - 1, rows, width, int(cand), int(bool(track_dirty)),
        PATHS.index(plan.path), plan.threads, plan.blocks, plan.cluster,
        plan.smem_bytes, plan.group, stream,
    )
    if err:
        raise RuntimeError(f"kcore_fused_sweep launch failed with CUDA error {err}")
    fused_sweep_op.launches += 1
    return est, changed, dirty


fused_sweep_op.launches = 0
