"""The H100's launch limits and the row-kernel launch plan.

:func:`fused_launch_plan` decides how one bucket of rows is launched on the
card by the two h-index kernels, ``csrc/fused.cu`` (gather + h-index + dirty
push) and ``csrc/hindex.cu`` (h-index of rows gathered beforehand): both
launch the row paths of ``csrc/hist_common.cuh`` and ``csrc/hindex_common.cuh``
through one launcher, and their C entry points only launch the plan they
are given, so the CPU tests reach every rule. The partial-counts kernel's
plan (``kernels/counts/ops.py``) takes its card limits and its cluster rule
from here.
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, NamedTuple, Optional, Tuple

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
