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

:func:`counts_launch_plan` decides how a shard is launched (the width
class's path, block size, grid, cluster, shared memory and rows per
block); the C entry point only launches what it is given, so the CPU tests
reach every rule.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.plan import (GRID_LIMIT, HIST_SCRATCH, MAX_BINS, SMEM_PER_BLOCK, SMS,
                                      checked_plan, count_launch, hist_split)

# The kernel's block sizes (counts.cu kStepBlock, kWarpBlock): a step block
# stages rounds of STEP_BLOCK / 8 or STEP_BLOCK / 16 rows, and enough rounds
# that each thread writes at least 4 vectors of 4 counts (STEP_MIN_SPAN
# counts a block; only a cand under 256 can need more than one round), up to
# STEP_MAX_ROUNDS and while the grid keeps a block for every SM; a warp
# block takes WARP_ROWS rows.
COUNTS_PATHS = ("step", "warp", "hist")  # counts.cu's enum CountsPath, in order
STEP_BLOCK = 256
STEP_MIN_SPAN = 16 * STEP_BLOCK
STEP_MAX_ROUNDS = 32
WARP_ROWS = 8


class CountsPlan(NamedTuple):
    """How one slot shard is launched: ``path`` (one of
    :data:`COUNTS_PATHS`), ``threads`` per block, ``blocks`` in the grid,
    ``cluster`` blocks per thread-block cluster (the blocks of one row on
    the hist path), ``smem_bytes`` of dynamic shared memory, and
    ``rows_per_block`` (per cluster on the hist path)."""

    path: str
    threads: int
    blocks: int
    cluster: int
    smem_bytes: int
    rows_per_block: int


def _warp_smem(cand: int) -> int:
    """Shared memory of a warp block: WARP_ROWS histograms of ``cand`` bins
    each, padded to whole 16-byte vectors at any alignment of the row."""
    return WARP_ROWS * ((cand + 6) // 4 * 4) * 4


@functools.lru_cache(maxsize=4096)
def counts_launch_plan(rows: int, w_local: int, cand: int, *,
                       path: Optional[str] = None,
                       cluster: Optional[int] = None) -> CountsPlan:
    """The launch plan of ``csrc/counts.cu`` for a ``[rows, w_local]`` slot
    shard with candidate window ``cand`` (a pure function of the shapes).

    Paths by width:

    * ``step`` (``w_local <= 16``): a block stages a run of rows (8 or 16
      lanes rank each row's values) and writes their counts as one flat
      span with 16-byte stores;
    * ``warp`` (``w_local <= 1024``, and ``WARP_ROWS`` histograms of
      ``cand`` bins fit in shared memory): a warp per row with a
      warp-private histogram;
    * ``hist`` (otherwise): a block per row with a histogram of
      ``min(cand, MAX_BINS)`` bins (a larger ``cand`` is done window by
      window), split over a cluster as :func:`~repro_torch.kernels.plan.
      hist_split` says.

    ``path`` and ``cluster`` force a path (it must cover the shape) and a
    hist cluster; the rest follows from them.
    """
    rows, w_local, cand = int(rows), int(w_local), int(cand)
    if cand < 1:
        raise ValueError(f"counts_launch_plan: cand {cand} must be >= 1")
    warp_fits = w_local <= 1024 and _warp_smem(cand) <= SMEM_PER_BLOCK
    if path is None:
        path = "step" if w_local <= 16 else "warp" if warp_fits else "hist"
    if cluster is not None and path != "hist":
        raise ValueError(f"counts_launch_plan: a cluster is only planned on the hist path, "
                         f"not {path!r}")
    if path == "step" and w_local <= 16:
        group = 8 if w_local <= 8 else 16
        per_round = STEP_BLOCK // group
        rounds = -(-STEP_MIN_SPAN // (per_round * cand))
        rounds = max(1, min(rounds, STEP_MAX_ROUNDS, rows // (per_round * SMS)))
        rpb = per_round * rounds
        plan = CountsPlan(path, STEP_BLOCK, -(-rows // rpb), 1, rpb * group * 4, rpb)
    elif path == "warp" and warp_fits:
        plan = CountsPlan(path, 32 * WARP_ROWS, -(-rows // WARP_ROWS), 1, _warp_smem(cand),
                          WARP_ROWS)
    elif path == "hist":
        try:
            cluster, threads = hist_split(rows, w_local, cluster)
        except ValueError as e:
            raise ValueError(f"counts_launch_plan: {e}") from None
        plan = CountsPlan(path, threads, rows * cluster, cluster,
                          (min(cand, MAX_BINS) + HIST_SCRATCH) * 4, 1)
    else:
        raise ValueError(f"counts_launch_plan: path {path!r} cannot take width {w_local} "
                         f"with cand {cand}")
    if plan.blocks > GRID_LIMIT:
        raise ValueError(f"counts_launch_plan: {plan.blocks} blocks exceed the grid's "
                         f"{GRID_LIMIT}")
    return plan

# The plain version materializes at most this many [row, slot, candidate]
# compares at a time (rows and candidates are chunked), so hub widths stay
# within memory.
_PLAIN_CHUNK = 1 << 27

_fn = None


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


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load

        fn = load("counts").kcore_partial_counts
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, ext, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,          # rows, width, cand
            ctypes.c_int, ctypes.c_int, ctypes.c_int,          # path, threads, blocks
            ctypes.c_int, ctypes.c_int, ctypes.c_int,          # cluster, smem_bytes, rows_per_block
            ctypes.c_void_p,                                   # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    if x.device.type == "cpu" and ext.device.type == "cpu":
        return partial_counts_plain(x, ext, cand=cand)
    if x.device.type == "meta" and ext.device.type == "meta":
        # The kernel's shape function, for a traced dry-run: a meta tensor
        # has no data. The tally prices what the kernel would do.
        out = torch.empty(rows, int(cand), dtype=torch.int32, device="meta")
        _record(x, out)
        return out
    if x.device.type != "cuda" or ext.device != x.device:
        raise ValueError(f"partial_counts_op: x on {x.device}, ext on {ext.device}; "
                         f"both must be on one CUDA device, both on the CPU or both "
                         f"on meta")
    if not (x.is_contiguous() and ext.is_contiguous()):
        raise ValueError("partial_counts_op: x and ext must be contiguous")
    out = torch.empty(rows, int(cand), dtype=torch.int32, device=x.device)
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), ext.data_ptr(), out.data_ptr(), rows, width, int(cand),
                    COUNTS_PATHS.index(plan.path), plan.threads, plan.blocks, plan.cluster,
                    plan.smem_bytes, plan.rows_per_block, stream)
    if err:
        raise RuntimeError(f"kcore_partial_counts launch failed with CUDA error {err}")
    count_launch(partial_counts_op)
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
