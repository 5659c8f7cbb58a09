"""The H100's launch limits, the kernels' launch plans and their one launch path.

:func:`fused_launch_plan` decides how one bucket of rows is launched on the
card by the two h-index kernels, ``csrc/fused.cu`` (gather + h-index + dirty
push) and ``csrc/hindex.cu`` (h-index of rows gathered beforehand): both
launch the row paths of ``csrc/hist_common.cuh`` and ``csrc/hindex_common.cuh``
through one launcher. :func:`counts_launch_plan` decides how one slot shard is
launched by the partial-counts kernel, ``csrc/counts.cu``. The C entry points
only launch the plan they are given, so the CPU tests reach every rule.

Every kernel wrapper (``kernels/*/ops.py``) places its call with
:func:`placement` and enqueues it with :func:`launch`, which knows the C
convention the entry points share.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.build import bind

# The card's limits, for the H100 SXM: its SMs; the shared memory one block
# may take after opting in (227 KB); the histogram bins that fit there
# beside the kernels' scratch ints (hist_common.cuh kHistScratch); the
# largest portable cluster. The paths' block sizes are each at most their
# kernel's __launch_bounds__ (hist_common.cuh kGroupBlock, hindex_common.cuh
# kThreadBlock and kRowBlock).
SMS = 132
SMEM_PER_BLOCK = 232_448
HIST_SCRATCH = 64
MAX_BINS = 57_344
MAX_CLUSTER = 8
GROUP_BLOCK = 128
WARP_BLOCK = 256
SEARCH_BLOCK = 1024
PATHS = ("group", "warp", "hist", "search")  # hist_common.cuh's enum Path, in order
GRID_LIMIT = 2**31 - 1  # blocks in a one-dimensional grid


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


def hist_split(rows: int, width: int, cluster: Optional[int] = None) -> Tuple[int, int]:
    """``(cluster, threads)`` of a shared-memory histogram launch with one
    row per block or per cluster. A tile with fewer rows than ``SMS``
    splits each row over a cluster of up to ``MAX_CLUSTER`` blocks (while
    each block keeps at least 1,024 slots), so its rows reach every SM (on
    the H100 that beat one block a row 2-4x on tiles of 8 and 24 rows of
    the fused kernel, and lost 8% on one of 192); 256-1,024 threads a
    block, about 8 slots a thread. ``cluster`` forces the split."""
    if cluster is None:
        want = -(-SMS // max(rows, 1))
        cluster = 1
        while cluster < min(want, MAX_CLUSTER) and width // (2 * cluster) >= 1024:
            cluster *= 2
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster {cluster} not in [1, {MAX_CLUSTER}]")
    share = -(-width // cluster)
    return cluster, min(1024, max(256, _next_pow2(-(-share // 8))))


@functools.lru_cache(maxsize=4096)
def fused_launch_plan(rows: int, width: int, cand: int, *,
                      path: Optional[str] = None,
                      cluster: Optional[int] = None) -> FusedPlan:
    """The launch plan of ``csrc/fused.cu`` and ``csrc/hindex.cu`` for a
    ``[rows, width]`` bucket with candidate window ``cand`` (a pure
    function of the shapes).

    Paths by width, with ``B = min(max(cand, 1), width)``:

    * ``group`` (width <= 16): 8 or 16 lanes per row, ``GROUP_BLOCK``
      threads a block, so a 10 k-row width-8 tile makes 670 blocks;
    * ``warp`` (width <= 1024): a warp per row, ``WARP_BLOCK`` threads;
    * ``hist`` (wider, ``B + 1 <= MAX_BINS``): a shared-memory histogram of
      ``B + 1`` bins per row, split over a cluster as :func:`hist_split`
      says;
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
        plan = FusedPlan(path, GROUP_BLOCK, -(-rows * group // GROUP_BLOCK), 1, 0, group)
    elif path == "warp" and width <= 1024:
        plan = FusedPlan(path, WARP_BLOCK, -(-rows * 32 // WARP_BLOCK), 1, 0, 32)
    elif path == "hist" and bound + 1 <= MAX_BINS:
        try:
            cluster, threads = hist_split(rows, width, cluster)
        except ValueError as e:
            raise ValueError(f"fused_launch_plan: {e}") from None
        plan = FusedPlan(path, threads, rows * cluster, cluster,
                         (bound + 1 + HIST_SCRATCH) * 4, threads)
    elif path == "search":
        plan = FusedPlan(path, SEARCH_BLOCK, rows, 1, 0, SEARCH_BLOCK)
    else:
        raise ValueError(f"fused_launch_plan: path {path!r} cannot take width {width} "
                         f"with cand {cand}")
    if plan.blocks > GRID_LIMIT:
        raise ValueError(f"fused_launch_plan: {plan.blocks} blocks exceed the grid's "
                         f"{GRID_LIMIT}")
    return plan


# The counts kernel's block sizes (counts.cu kStepBlock, kWarpBlock): a step
# block stages rounds of STEP_BLOCK / 8 or STEP_BLOCK / 16 rows, and enough
# rounds that each thread writes at least 4 vectors of 4 counts (STEP_MIN_SPAN
# counts a block; only a cand under 256 can need more than one round), up to
# STEP_MAX_ROUNDS and while the grid keeps a block for every SM; a warp block
# takes WARP_ROWS rows.
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
      window), split over a cluster as :func:`hist_split` says.

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


def checked_plan(who: str, plan: Optional[NamedTuple], make: Callable[..., NamedTuple],
                 rows: int, width: int, cand: int) -> NamedTuple:
    """``plan``, or ``make(rows, width, cand)`` when it is None. A given
    plan must be the one ``make`` returns for these shapes with the plan's
    path (and, on the hist path, its cluster) forced: tests and
    ``chip_smoke.py`` pass one to reach every path; any other plan raises
    ``ValueError``."""
    if plan is None:
        return make(rows, width, cand)
    try:
        want = make(rows, width, cand, path=plan.path,
                    cluster=plan.cluster if plan.path == "hist" else None)
    except ValueError:
        want = None
    if plan != want:
        raise ValueError(f"{who}: {plan} is not a launch plan for [{rows}, {width}] "
                         f"rows with cand {cand}")
    return plan


# The wrappers' launch counters. Part-parallel conquer launches from several
# slice threads at once, so a launch is counted under one lock.
_COUNT_LOCK = threading.Lock()


def count_launch(op) -> None:
    """Add one launch to ``op.launches`` and to the calling thread's tally in
    ``op.launches_by_thread`` (keyed by thread name: slice ``i`` of a wave
    runs on ``dckcore-conquer-<i>``), both under one lock."""
    name = threading.current_thread().name
    with _COUNT_LOCK:
        op.launches += 1
        op.launches_by_thread[name] = op.launches_by_thread.get(name, 0) + 1


def placement(who: str, tensors: Sequence[torch.Tensor], *, meta: bool = False) -> str:
    """Where a kernel wrapper's call runs, from its tensors: ``"cpu"`` when
    all are on the CPU (the plain version), ``"meta"`` when all are on meta
    and the op has a shape function (``meta``), else ``"cuda"``, which needs
    them all on one CUDA device and contiguous; any other mix raises
    ``ValueError``. A wrapper never falls back from one to another."""
    first = tensors[0].device
    if all(t.device.type == "cpu" for t in tensors):
        return "cpu"
    if meta and all(t.device.type == "meta" for t in tensors):
        return "meta"
    if first.type != "cuda" or any(t.device != first for t in tensors):
        where = ", ".join(sorted({str(t.device) for t in tensors}))
        rest = ", all on the CPU or all on meta" if meta else " (or all on the CPU)"
        raise ValueError(f"{who}: tensors on {where}; all must be on one CUDA device{rest}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{who}: all tensors must be contiguous")
    return "cuda"


# What every C entry point in csrc/ takes after its own arguments: the plan's
# path (the index in the kernel's enum), threads, blocks, cluster, shared
# memory bytes and rows a group or block (the plans' fields in order).
_PLAN_ARGTYPES = (ctypes.c_int,) * 6


def launch(op, lib: str, symbol: str, argtypes: Tuple, args: Tuple, plan: NamedTuple,
           device: torch.device) -> None:
    """Enqueue ``symbol`` of ``csrc/<lib>.cu`` on ``device``'s current
    stream and count the launch on ``op`` (:func:`count_launch`). The entry
    point takes ``args`` (of ctypes types ``argtypes``), then the plan's
    fields, then the stream, and returns the launch's CUDA error, which
    raises ``RuntimeError``. A plan of no blocks (no rows) enqueues
    nothing."""
    if plan.blocks == 0:
        return
    paths = COUNTS_PATHS if isinstance(plan, CountsPlan) else PATHS
    fn = bind(lib, symbol, argtypes + _PLAN_ARGTYPES)
    err = fn(*args, paths.index(plan.path), *plan[1:],
             torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {err}")
    count_launch(op)
