"""DC-kCore orchestrator: the sequential divide / conquer / merge loop.

Implements the pipeline of paper Section 4 for an arbitrary number of
parts (Section 5.6 evaluates 2-4):

  1. Sort thresholds descending: ``t_p > ... > t_1``.
  2. For each threshold ``t`` on the *remaining* graph: extract candidates
     (Exact- or Rough-Divide), build the part with its external information,
     decompose it (conquer), and finalize every node whose value is >= ``t``
     (Exact finalizes all by construction). Update ``ext`` of the remaining
     nodes with their freshly-finalized neighbors and shrink the remaining
     graph.
  3. Decompose the final remaining part and finalize everything.
  4. Merge: scatter part coreness back through the id maps.

Parts conquer one at a time, so the peak device footprint is the max over
parts instead of the whole graph -- the paper's resource story. The divide
passes run chunked over CSR row ranges (``divide_chunk`` adjacency slots),
so their host transient is bounded by the chunk budget, and each part
reports its observed peak.

**Overlapped pipeline.** With ``overlap=True`` one worker thread (named
``dckcore-prefetch``) runs the *next* part's divide passes, reorder and
bucketize -- numpy only, it makes no CUDA call, so the conquer stream is
the only one in use -- while the current part sweeps on the device, and the
checkpoint saves go through the managers' async threads. The prefetch is
speculative: the worker assumes every candidate of the conquering part
finalizes (exact by construction for Exact-Divide, a bet for Rough). After
the conquer the bet is checked against the actual finalized set: on a hit
the prefetched shrink and next plan are adopted (byte-identical to the
sequential fold, every divide pass being deterministic); on a miss they are
discarded and recomputed synchronously. Coreness is byte-identical with the
flag on or off. The worker only ever reads the graph and ``ext`` it was
handed; the main thread rebinds its state to fresh arrays instead of
mutating them. ``close()`` joins the worker and drains both managers on
every exit path, a crash included.

**Part-parallel waves.** ``part_parallel=S`` conquers up to ``S``
consecutive parts at once per wave (:mod:`repro_torch.core.partsched`): the
wave planner chains speculative shrinks (part ``i+1`` planned on part
``i``'s predicted shrink, the overlap prefetch at depth ``S``), the LPT
scheduler places each part on a slice by its modeled cost, and the merge
validates the predictions strictly in plan order, discarding the wave's
tail on the first miss. Slices are worker threads named
``dckcore-conquer-<i>``; on a CUDA device each runs its parts on its own
CUDA stream (*stream slices*), created once per run. With
``part_parallel_plan`` (a :class:`~repro_torch.core.distributed.MeshPlan`
over a process group) the slices are blocks of ranks instead (*rank
slices*): every rank plans the same waves, conquers only its own slice's
parts through that slice's distributed engine, and receives every other
part's result from its slice's first rank over the world group, in cursor
order; the merge, the E(v) folds (over the whole plan, on the device) and
the checkpoints then run identically on every rank. Coreness, reports,
checkpoints and sweep snapshots are byte-identical to the sequential path
either way; only the lead part of a wave (the one the last boundary
checkpoint points at) consults or writes sweep snapshots.

**Fault injection and tolerance.** ``fault_plan`` (a
:class:`~repro_torch.runtime.FaultPlan`) is visited at the pipeline's named
sites: ``prefetch`` (the worker's task), ``boundary_fold`` (every E(v)
fold, sequential and speculative), ``checkpoint_save`` (every boundary
save) and ``slice_conquer`` (before each attempt of a part on a slice). A
fault at the first three is fail-fast, like a real crash: the run drains
and re-raises, and recovery is the resume path. ``slice_timeout_s`` /
``max_retries`` arm the wave watchdog on stream and thread slices: a
failed part retries on its slice with exponential backoff, and a slice
that hangs or runs out of retries is blacklisted for the rest of the run,
its parts re-planned over the survivors.

**Per-part checkpoints.** With ``checkpoint_dir`` set, the host state
between parts (:class:`PipelineState`: coreness, the finalized mask, ``ext``
of the remaining nodes, the remaining-id map, the threshold cursor and the
per-part reports) is saved atomically after every part, and
``resume=True`` re-enters at the first unfinished part; the remaining
graph is rebuilt from the original graph and the finalized mask. A killed
run leaves at most a ``step_*.tmp`` directory, which restore ignores.

**Sweep snapshots.** ``sweep_checkpoint_every=k`` also saves the conquer
engine's estimate vector (a :class:`SweepSnapshot`, fed by the engine's
``on_sweep`` hook) every ``k`` sweeps under ``<checkpoint_dir>/sweeps``;
resume then re-enters *mid-part* via ``init_coreness``. The fixed point is
exact from any valid upper bound, so the final coreness is byte-identical
to the uninterrupted run. Stale snapshots (another part, another run) are
detected and resume falls back to the part boundary.

The on-disk format is the JAX package's, so a checkpoint directory written
by ``repro.core.dckcore`` resumes here and the other way round.

**Spans.** While a torch profiler records (:mod:`repro_torch.trace`), a
call records ``repro_torch.dckcore`` with the children ``.divide`` (each
part's plan), ``.layout`` (reorder and bucketize), ``.conquer``,
``.merge`` and ``.shrink`` (the E(v) fold and the shrink of the remaining
graph); the divide passes record ``repro_torch.divide.exact``,
``.induce`` and ``.external`` inside them.

This is the port of the JAX package's ``repro.core.dckcore``; the per-part
reports are field-for-field the same. The watchdog on rank slices is not
ported (``ROADMAP.md``, queue 1, "the watchdog on rank slices") and raises
:class:`NotImplementedError`.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import logging
import os
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.decompose import DecomposeResult, decompose
from repro_torch.core.divide import timed_candidates
from repro_torch.graph.build import (
    DivideStats,
    _resolve_chunk_slots,
    bucketize,
    external_info,
    induced_subgraph,
)
from repro_torch.graph.reorder import bitmap_density, reorder_graph
from repro_torch.graph.structs import BucketedGraph, Graph
from repro_torch.trace import spanned

STATE_FORMAT = 1
SWEEP_FORMAT = 1

# The prefetch worker thread carries this name prefix; the test suite
# asserts none outlive a test (a leaked thread = a missing close()).
PREFETCH_THREAD_PREFIX = "dckcore-prefetch"


class MergeIncompleteError(RuntimeError):
    """The final merge left nodes without a coreness value.

    This is the pipeline's last correctness gate (every node must be
    finalized by exactly one part); a bare ``assert`` here would vanish
    under ``python -O`` and let a broken merge return garbage silently.
    """


def graph_fingerprint(g: Graph) -> Dict[str, int]:
    """Cheap identity of a graph: node and edge counts plus a CRC of the
    degree sequence. O(n), no edge traversal."""
    deg = np.ascontiguousarray(g.degrees, dtype=np.int64)
    return {
        "n_nodes": int(g.n_nodes),
        "n_edges": int(g.n_edges),
        "deg_crc32": int(zlib.crc32(deg.tobytes())),
    }


@dataclasses.dataclass
class PartReport:
    name: str
    threshold: Optional[int]
    n_nodes: int
    n_edges: int
    iterations: int
    comm_amount: int
    peak_bytes: int
    extract_time_s: float
    decompose_time_s: float
    finalized: int
    # Work metric (active-frontier scheduling): rows actually gathered +
    # h-indexed across all sweeps, vs what always-full sweeps would gather.
    gathered_rows: int = 0
    full_sweep_rows: int = 0
    active_rows_per_iter: List[int] = dataclasses.field(default_factory=list)
    # Measured per-device collective bytes across the part's sweeps (0 for
    # the single-device engine -- it issues no collectives).
    collective_bytes: int = 0
    # Fraction of set bits in the part's bucket-adjacency bitmap: how often
    # the static frontier filter could NOT rule out a tile.
    bitmap_density: float = 1.0
    # Seconds the pipeline was blocked on this part's boundary save, and
    # the wall seconds of the completed save (the same on the blocking
    # path); 0 when checkpointing is off.
    save_time_s: float = 0.0
    save_wall_s: float = 0.0
    # Peak transient host bytes of the part's divide passes (candidate
    # extraction + induced subgraph + ext fold + shrink), bounded by the
    # chunk budget -- see repro_torch.graph.build.DivideStats.
    divide_transient_bytes: int = 0
    # Sweep a part was warm-restarted at from a snapshot, whether its
    # divide was prefetched, and its part-parallel placement and retries:
    # the defaults of the sequential path, kept so reports line up field
    # for field with the JAX package's.
    resumed_at_sweep: int = 0
    prefetched: bool = False
    slice_index: int = -1
    wave: int = -1
    modeled_cost_bytes: int = 0
    retries: int = 0


@dataclasses.dataclass
class DCKCoreReport:
    parts: List[PartReport]
    total_time_s: float
    preprocess_time_s: float
    resumed_parts: int = 0  # parts restored from checkpoint, not re-run
    overlap: bool = False     # divide/checkpoint overlapped with conquer?
    prefetch_hits: int = 0    # speculative shrinks adopted
    prefetch_misses: int = 0  # speculative shrinks discarded + recomputed
    # Part-parallel conquer (0 = sequential): slice count, wall seconds the
    # wave executor ran, per-slice busy seconds (sweep wall summed over the
    # slice's parts), speculative conquers discarded after a mispredicted
    # wave, and the collective bytes of the rank slices' E(v) boundary
    # folds (0 when the fold ran on the host).
    part_parallel: int = 0
    conquer_wall_s: float = 0.0
    slice_busy_s: List[float] = dataclasses.field(default_factory=list)
    speculation_discards: int = 0
    boundary_exchange_bytes: int = 0
    # Fault tolerance: retried conquer attempts, slices blacklisted (a hang
    # or retries run out), waves that finished on fewer slices than
    # planned, checkpoint steps quarantined as corrupt during restore, and
    # the event log (retry / blacklist / replan / quarantine, in order).
    retries: int = 0
    blacklisted_slices: List[int] = dataclasses.field(default_factory=list)
    degraded_waves: int = 0
    quarantined_steps: int = 0
    fault_events: List[dict] = dataclasses.field(default_factory=list)

    @property
    def total_comm(self) -> int:
        return sum(p.comm_amount for p in self.parts)

    @property
    def peak_bytes(self) -> int:
        return max((p.peak_bytes for p in self.parts), default=0)

    @property
    def total_iterations(self) -> int:
        return sum(p.iterations for p in self.parts)

    @property
    def total_gathered_rows(self) -> int:
        """Total sweep work across parts (frontier-scheduled)."""
        return sum(p.gathered_rows for p in self.parts)

    @property
    def total_full_sweep_rows(self) -> int:
        """Work the always-full-sweep schedule would have done."""
        return sum(p.full_sweep_rows for p in self.parts)

    @property
    def total_collective_bytes(self) -> int:
        """Measured per-device collective bytes summed over all parts."""
        return sum(p.collective_bytes for p in self.parts)

    @property
    def total_save_time_s(self) -> float:
        """Wall time the pipeline was blocked on per-part checkpoint saves
        (the full save cost when saves block; near zero when async)."""
        return sum(p.save_time_s for p in self.parts)

    @property
    def total_save_wall_s(self) -> float:
        """Wall time of the completed per-part saves, whether or not the
        pipeline waited for them."""
        return sum(p.save_wall_s for p in self.parts)

    @property
    def total_decompose_time_s(self) -> float:
        """Wall time the conquer engine was actually sweeping."""
        return sum(p.decompose_time_s for p in self.parts)

    @property
    def idle_fraction(self) -> float:
        """Fraction of the run's wall clock the device spent NOT sweeping
        (divide passes, bucketize, checkpoint saves, merge) -- the stall
        metric ``overlap=True`` exists to shrink."""
        if self.total_time_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self.total_decompose_time_s / self.total_time_s)

    @property
    def slice_utilization(self) -> List[float]:
        """Per-slice busy fraction of the wave executor's wall clock -- how
        evenly the LPT schedule filled the slices (empty when
        sequential)."""
        if self.conquer_wall_s <= 0:
            return [0.0 for _ in self.slice_busy_s]
        return [min(1.0, b / self.conquer_wall_s) for b in self.slice_busy_s]


@dataclasses.dataclass
class PipelineState:
    """Host state of a DC-kCore run at a part boundary -- the checkpoint unit.

    ``parts_done`` is the cursor: how many thresholds of the (descending,
    deduplicated) plan have been consumed. ``complete`` marks that the
    final "rest" part also finished; a resume of a complete state returns
    the stored result without touching the graph.
    """

    coreness: np.ndarray       # [n] int32, -1 where unfinalized
    finalized: np.ndarray      # [n] bool
    ext_remaining: np.ndarray  # [n_remaining] int32, remaining-local order
    remaining_ids: np.ndarray  # [n_remaining] int64, remaining-local -> orig
    thresholds: List[int]      # the descending plan
    fingerprint: Dict[str, int] = dataclasses.field(default_factory=dict)
    parts_done: int = 0
    complete: bool = False
    reports: List[PartReport] = dataclasses.field(default_factory=list)

    @staticmethod
    def fresh(g: Graph, thresholds: Sequence[int]) -> "PipelineState":
        n_nodes = g.n_nodes
        return PipelineState(
            coreness=np.full(n_nodes, -1, dtype=np.int32),
            finalized=np.zeros(n_nodes, dtype=bool),
            ext_remaining=np.zeros(n_nodes, dtype=np.int32),
            remaining_ids=np.arange(n_nodes, dtype=np.int64),
            thresholds=[int(t) for t in thresholds],
            fingerprint=graph_fingerprint(g),
        )

    # -- checkpoint wire format ----------------------------------------- #
    def arrays(self) -> dict:
        """The arrays saved per part (scalars and reports ride in extra)."""
        return {
            "coreness": self.coreness,
            "finalized": self.finalized,
            "ext_remaining": self.ext_remaining,
            "remaining_ids": self.remaining_ids,
        }

    def extra(self) -> dict:
        return {
            "format": STATE_FORMAT,
            "parts_done": int(self.parts_done),
            "complete": bool(self.complete),
            "thresholds": [int(t) for t in self.thresholds],
            "fingerprint": dict(self.fingerprint),
            "reports": [dataclasses.asdict(p) for p in self.reports],
        }

    def save(self, manager, blocking: bool = True,
             on_done: Optional[Callable[[int, float], None]] = None) -> float:
        """Atomic save at the current part boundary through ``manager`` (a
        :class:`~repro_torch.ckpt.CheckpointManager`, which keeps its
        ``retain`` newest steps); returns the seconds the caller was
        blocked (the whole save when ``blocking``, else waiting out the
        previous save plus the by-value copy).

        Step number = parts completed so far (the rest part counts one
        past the last threshold), so ``latest_step`` is the cursor. A
        part's own save time is known only after its save, so it is
        persisted one boundary later. The previous save is waited out
        before ``extra()`` serializes the reports, so its ``on_done``
        stamp always lands first."""
        t0 = time.perf_counter()
        manager.wait()
        step = self.parts_done + (1 if self.complete else 0)
        manager.save(self.arrays(), step, extra=self.extra(),
                     blocking=blocking, on_done=on_done)
        return time.perf_counter() - t0

    @staticmethod
    def restore(checkpoint_dir: str, n_nodes: int,
                events: Optional[List[dict]] = None) -> Optional["PipelineState"]:
        """Latest *intact* checkpoint under ``checkpoint_dir`` (``None`` if
        there is none). A corrupt step is quarantined to ``step_*.corrupt``
        and restore falls back to the previous retained step; ``events``
        collects one ``{"event": "quarantine", ...}`` record per
        quarantined step."""
        from repro_torch.ckpt import latest_step, restore_pytree_with_fallback

        if latest_step(checkpoint_dir) is None:
            return None
        template = {
            "coreness": np.zeros(0, np.int32),
            "finalized": np.zeros(0, bool),
            "ext_remaining": np.zeros(0, np.int32),
            "remaining_ids": np.zeros(0, np.int64),
        }

        def on_corrupt(step, exc):
            if events is not None:
                events.append({
                    "event": "quarantine", "path": checkpoint_dir,
                    "step": int(step), "error": str(exc),
                })

        try:
            arrays, _step, extra = restore_pytree_with_fallback(
                checkpoint_dir, template, on_corrupt=on_corrupt
            )
        except FileNotFoundError:
            return None  # every step was corrupt: resume from scratch
        if extra.get("format") != STATE_FORMAT:
            raise ValueError(
                f"checkpoint format {extra.get('format')!r} != {STATE_FORMAT}"
            )
        if arrays["coreness"].shape[0] != n_nodes:
            raise ValueError(
                f"checkpoint is for a {arrays['coreness'].shape[0]}-node graph, "
                f"got {n_nodes} nodes"
            )
        return PipelineState(
            coreness=arrays["coreness"],
            finalized=arrays["finalized"],
            ext_remaining=arrays["ext_remaining"],
            remaining_ids=arrays["remaining_ids"],
            thresholds=[int(t) for t in extra["thresholds"]],
            fingerprint={k: int(v) for k, v in extra["fingerprint"].items()},
            parts_done=int(extra["parts_done"]),
            complete=bool(extra["complete"]),
            reports=[PartReport(**r) for r in extra["reports"]],
        )


def _sweep_dir(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "sweeps")


@dataclasses.dataclass
class SweepSnapshot:
    """Mid-part checkpoint: one conquer sweep's coreness estimates.

    The fixed point restarts from ANY valid upper bound of the true
    coreness, so a snapshot taken by the ``on_sweep`` hook is a complete
    mid-part resume point: re-enter the part with ``init_coreness`` and the
    remaining sweeps reach the same fixed point.

    Saved under ``<checkpoint_dir>/sweeps`` with ``step`` numbering that is
    monotone across the whole run (parts-done major, sweep minor), so the
    manager's retention can never prefer a stale higher-numbered snapshot.
    A snapshot is valid only for the part it was taken in: :meth:`matches`
    checks the cursor, graph fingerprint, threshold plan and part size.
    ``coreness`` is int32 in **part-local original-id order**, so a
    snapshot taken under one engine, node order or tile policy restarts
    under any other.
    """

    coreness: np.ndarray       # [n_part] int32, part-local original order
    parts_done: int            # pipeline cursor when taken
    sweep: int                 # sweep number within the part
    n_part: int
    threshold: Optional[int]   # None for the rest part
    thresholds: List[int]
    fingerprint: Dict[str, int]

    _PART_STRIDE = 1 << 40

    @property
    def step(self) -> int:
        return self.parts_done * SweepSnapshot._PART_STRIDE + self.sweep

    def save(self, manager, blocking: bool = True) -> float:
        """Save the snapshot through ``manager``; returns the seconds the
        caller was blocked (async on the overlapped pipeline: the write
        runs on the manager's thread while the part keeps sweeping)."""
        t0 = time.perf_counter()
        extra = {
            "format": SWEEP_FORMAT,
            "parts_done": int(self.parts_done),
            "sweep": int(self.sweep),
            "n_part": int(self.n_part),
            "threshold": None if self.threshold is None else int(self.threshold),
            "thresholds": [int(t) for t in self.thresholds],
            "fingerprint": dict(self.fingerprint),
        }
        manager.save(
            {"part_coreness": np.asarray(self.coreness, dtype=np.int32)},
            self.step, extra=extra, blocking=blocking,
        )
        return time.perf_counter() - t0

    @staticmethod
    def restore(sweep_dir: str,
                events: Optional[List[dict]] = None) -> Optional["SweepSnapshot"]:
        """Latest intact snapshot under ``sweep_dir``; ``None`` when there
        is none or it is unreadable or of another format -- snapshots are
        an optimization, so a bad one degrades to part-boundary resume (and
        is logged). A corrupt snapshot is quarantined and the previous
        retained one tried; ``events`` collects the quarantine records."""
        from repro_torch.ckpt import latest_step, restore_pytree_with_fallback

        if latest_step(sweep_dir) is None:
            return None

        def on_corrupt(step, exc):
            if events is not None:
                events.append({
                    "event": "quarantine", "path": sweep_dir,
                    "step": int(step), "error": str(exc),
                })

        try:
            arrays, _step, extra = restore_pytree_with_fallback(
                sweep_dir, {"part_coreness": np.zeros(0, np.int32)},
                on_corrupt=on_corrupt,
            )
        except FileNotFoundError:
            return None  # every snapshot corrupt: part-boundary resume
        except Exception as exc:
            logging.getLogger(__name__).warning(
                "sweep snapshot %s unreadable (%s: %s) -- resuming from the "
                "part boundary instead", sweep_dir, type(exc).__name__, exc,
            )
            return None
        if extra.get("format") != SWEEP_FORMAT:
            logging.getLogger(__name__).warning(
                "sweep snapshot %s has format %r (expected %r) -- resuming "
                "from the part boundary instead",
                sweep_dir, extra.get("format"), SWEEP_FORMAT,
            )
            return None
        return SweepSnapshot(
            coreness=arrays["part_coreness"],
            parts_done=int(extra["parts_done"]),
            sweep=int(extra["sweep"]),
            n_part=int(extra["n_part"]),
            threshold=(None if extra["threshold"] is None else int(extra["threshold"])),
            thresholds=[int(t) for t in extra["thresholds"]],
            fingerprint={k: int(v) for k, v in extra["fingerprint"].items()},
        )

    def matches(self, state: "PipelineState", cursor: int,
                n_part: int, threshold: Optional[int]) -> bool:
        """Is this snapshot a resume point for the part about to run?"""
        return (
            self.parts_done == cursor
            and self.n_part == n_part == self.coreness.shape[0]
            and self.threshold == threshold
            and self.thresholds == state.thresholds
            and self.fingerprint == state.fingerprint
        )


# Conquer-engine adapter. Called as ``fn(bg)``; when a sweep snapshot is
# to be restored or saved, as ``fn(bg, init_coreness=..., on_sweep=...)``
# (the built-in engines and make_distributed_decompose accept both).
DecomposeFn = Callable[..., DecomposeResult]
PartHook = Callable[[int, PartReport], None]
SweepSavedHook = Callable[[int, int, float], None]


@dataclasses.dataclass
class PartPlan:
    """Divide-stage output: everything the conquer stage needs for one part.

    ``threshold is None`` marks the final "rest" part (everything left,
    no candidate mask). ``part_g is None`` marks an *empty* threshold part
    (no candidates at this threshold -- the cursor advances, nothing runs).
    ``speculative`` records that the plan was built by the prefetch worker
    on the *predicted* remaining graph; it is only ever executed after the
    prediction was validated.
    """

    cursor: int
    name: str
    threshold: Optional[int]
    part_g: Optional[Graph]
    part_local_ids: Optional[np.ndarray]
    part_ext: Optional[np.ndarray]
    cand_mask: Optional[np.ndarray]
    dstats: DivideStats
    extract_time_s: float
    bg: Optional[BucketedGraph] = None
    bucketize_time_s: float = 0.0
    speculative: bool = False

    @property
    def is_rest(self) -> bool:
        return self.threshold is None

    @property
    def is_empty(self) -> bool:
        return self.part_g is None


@dataclasses.dataclass
class _Prefetch:
    """Prefetch-worker output: the speculative shrink of the remaining
    graph (assuming every candidate of part ``base_cursor`` finalizes)
    plus, when there is one, the next part's plan built on that shrink."""

    base_cursor: int
    shrink_graph: Graph
    shrink_keep_ids: np.ndarray   # remaining-local ids kept by the shrink
    ext_next: np.ndarray          # ext of the kept nodes after the fold
    shrink_stats: DivideStats
    shrink_time_s: float
    plan: Optional[PartPlan] = None


class _PartPipeline:
    """The scheduler behind :func:`dc_kcore`: divide, conquer, merge, shrink
    and checkpoint, one part at a time (with the next part's divide
    prefetched on a worker thread when ``overlap`` is on), or a wave of
    parts at a time across slices when ``part_parallel`` is set.

    The main thread owns ``state`` and the conquer stage; the (optional,
    single) prefetch worker only reads the graph and ``ext`` passed to it
    at submit time -- the main thread rebinds ``state.ext_remaining`` /
    ``state.remaining_ids`` / ``self.remaining_graph`` to fresh arrays
    instead of mutating them. ``close()`` drains the worker and both
    checkpoint managers on every exit path.
    """

    def __init__(
        self, *,
        state: PipelineState,
        remaining_graph: Graph,
        thresholds: List[int],
        strategy: str,
        decompose_fn: DecomposeFn,
        row_align: int,
        reorder: str,
        max_bucket_rows,
        reorder_sample_edges: Optional[int],
        divide_chunk: Optional[int],
        on_part_done: Optional[PartHook],
        sweep_checkpoint_every: Optional[int] = None,
        on_sweep_saved: Optional[SweepSavedHook] = None,
        pending_snap: Optional[SweepSnapshot] = None,
        state_mgr=None,
        sweeps_mgr=None,
        overlap: bool = False,
        fault_plan=None,
        part_parallel: Optional[int] = None,
        slice_decomposes: Optional[List[DecomposeFn]] = None,
        slice_specs: Optional[list] = None,
        slice_plans: Optional[list] = None,
        slice_streams: Optional[list] = None,
        fold_plan=None,
        device="cuda",
        watchdog=None,
        divide_device=None,
    ):
        self.state = state
        self.remaining_graph = remaining_graph
        self.thresholds = thresholds
        self.strategy = strategy
        self.decompose_fn = decompose_fn
        self.row_align = row_align
        self.reorder = reorder
        self.max_bucket_rows = max_bucket_rows
        self.reorder_sample_edges = reorder_sample_edges
        self.divide_chunk = divide_chunk
        self.on_part_done = on_part_done
        self.sweep_checkpoint_every = sweep_checkpoint_every
        self.on_sweep_saved = on_sweep_saved
        self.pending_snap = pending_snap
        self.state_mgr = state_mgr
        self.sweeps_mgr = sweeps_mgr
        self.overlap = overlap
        self.fault_plan = fault_plan

        # Part-parallel conquer: slice count, one DecomposeFn per slice
        # (None = every slice thread shares ``decompose_fn``), the pure
        # SliceSpecs the scheduler prices against, the rank slices' plans
        # (None = thread or stream slices), one CUDA stream per slice (None
        # off the card), and the whole plan that routes the E(v) boundary
        # fold through the ranks on ``device`` (None = host fold).
        self.part_parallel = part_parallel
        self.slice_decomposes = slice_decomposes
        self.slice_specs = slice_specs
        self.slice_plans = slice_plans
        self.slice_streams = slice_streams
        self.fold_plan = fold_plan
        self.device = device
        # Where the divide passes run: None = numpy on the host, else a
        # torch device (main thread only: overlap and part_parallel refuse it).
        self.divide_device = divide_device
        self.slice_busy_s = [0.0] * (part_parallel or 0)
        self.conquer_wall_s = 0.0
        self.boundary_exchange_bytes = 0
        self.speculation_discards = 0
        self._wave_index = 0

        # Fault tolerance: the wave watchdog (None = fail-fast), the slices
        # blacklisted so far (they stay dead for the rest of the run, so
        # waves narrow S -> S-1 -> ... -> 1), and the retry / blacklist /
        # replan accounting.
        self.watchdog = watchdog
        self.blacklisted: set = set()
        self.retries = 0
        self.replans = 0
        self.degraded_waves = 0
        self.fault_events: List[dict] = []

        self.parts: List[PartReport] = state.reports
        self.preprocess_time_s = 0.0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self._future: Optional[concurrent.futures.Future] = None
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        if overlap:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=PREFETCH_THREAD_PREFIX
            )

    def _visit_fault(self, site: str, **ctx) -> None:
        """Chaos hook: consult the fault plan at a named site (no-op
        without one). These main-thread sites are fail-fast: a fault kills
        the run like a real crash, and recovery is the resume path. Only
        ``slice_conquer`` faults (visited inside the wave executor) are
        retried or re-planned in the run."""
        if self.fault_plan is not None:
            self.fault_plan.visit(site, **ctx)

    # ---------------- divide stage ---------------- #
    def _fresh_stats(self) -> DivideStats:
        return DivideStats(chunk_slots=_resolve_chunk_slots(self.divide_chunk))

    @spanned("repro_torch.dckcore.divide")
    def _plan_on(self, graph: Graph, ext: np.ndarray, cursor: int,
                 speculative: bool = False) -> Optional[PartPlan]:
        """Divide: plan the part at ``cursor`` on ``graph``/``ext``. Pure --
        runs on the main thread, or on the prefetch worker
        (``speculative=True``, on the predicted shrink)."""
        if cursor < len(self.thresholds):
            t = self.thresholds[cursor]
            dstats = self._fresh_stats()
            cand_mask, extract_time = timed_candidates(
                graph, ext, t, self.strategy,
                chunk_slots=self.divide_chunk, stats=dstats,
                device=self.divide_device,
            )
            if not cand_mask.any():
                return PartPlan(
                    cursor=cursor, name=f"core>={t}", threshold=t,
                    part_g=None, part_local_ids=None, part_ext=None,
                    cand_mask=cand_mask, dstats=dstats,
                    extract_time_s=extract_time, speculative=speculative,
                )
            t0 = time.perf_counter()
            part_g, part_local_ids = induced_subgraph(
                graph, cand_mask, chunk_slots=self.divide_chunk, stats=dstats,
                device=self.divide_device,
            )
            part_ext = ext[cand_mask]
            extract_time += time.perf_counter() - t0
            return PartPlan(
                cursor=cursor, name=f"core>={t}", threshold=t,
                part_g=part_g, part_local_ids=part_local_ids,
                part_ext=part_ext, cand_mask=cand_mask, dstats=dstats,
                extract_time_s=extract_time, speculative=speculative,
            )
        # Final (bottom) part: everything left.
        if graph.n_nodes == 0:
            return None
        return PartPlan(
            cursor=cursor, name="rest", threshold=None,
            part_g=graph, part_local_ids=None, part_ext=ext,
            cand_mask=None, dstats=self._fresh_stats(),
            extract_time_s=0.0, speculative=speculative,
        )

    def _build_plan(self, cursor: int) -> Optional[PartPlan]:
        """Divide on the CURRENT remaining graph."""
        return self._plan_on(
            self.remaining_graph, self.state.ext_remaining, cursor
        )

    @spanned("repro_torch.dckcore.layout")
    def _bucketize(self, plan: PartPlan) -> None:
        """Reorder + bucketize the part -- the device-layout half of the
        divide stage (numpy; prefetched plans arrive with ``bg`` built)."""
        if plan.bg is not None or plan.part_g is None:
            return
        t0 = time.perf_counter()
        # Reorder the part, not the whole graph: each part is a fresh id
        # space, and locality only has to hold within the tiles actually
        # decomposed together. part_ext stays in part-local original order;
        # bucketize permutes it in and the engine un-permutes coreness out.
        plan.bg = bucketize(
            reorder_graph(
                plan.part_g, self.reorder,
                sample_edges=self.reorder_sample_edges,
            ),
            ext=plan.part_ext, row_align=self.row_align,
            max_bucket_rows=self.max_bucket_rows,
        )
        plan.bucketize_time_s = time.perf_counter() - t0

    # ---------------- prefetch stage ---------------- #
    def _submit_prefetch(self, plan: PartPlan) -> None:
        """Speculate past ``plan``'s conquer on the worker thread: shrink
        the remaining graph as if EVERY candidate finalizes and build the
        next part's plan on the predicted shrink. The worker gets the
        current array references; the main thread only ever rebinds them."""
        if self._executor is None or plan.is_rest or plan.is_empty:
            return
        if self._future is not None:
            raise RuntimeError("a prefetch is already in flight")
        self._future = self._executor.submit(
            self._prefetch_task,
            self.remaining_graph, self.state.ext_remaining,
            plan.cand_mask, plan.cursor,
        )

    def _fold_external(self, graph: Graph, keep_local: np.ndarray,
                       upper_local: np.ndarray, stats: DivideStats) -> np.ndarray:
        """E(v) boundary fold: a host pass, or an all-reduce over the ranks
        when the pipeline holds a whole plan (rank slices), which also
        counts its bytes. Bit-identical either way. Only ever called from
        the thread that owns ``stats`` (the prefetch worker never runs with
        a fold plan: overlap and part_parallel exclude each other)."""
        self._visit_fault("boundary_fold", n_nodes=int(graph.n_nodes))
        if self.fold_plan is not None:
            from repro_torch.core.distributed import device_external_info

            delta, moved = device_external_info(
                graph, keep_local, upper_local, self.fold_plan,
                chunk_slots=self.divide_chunk, stats=stats, device=self.device,
            )
            self.boundary_exchange_bytes += moved
            return delta
        return external_info(
            graph, keep_local, upper_local,
            chunk_slots=self.divide_chunk, stats=stats, device=self.divide_device,
        )

    @spanned("repro_torch.dckcore.shrink")
    def _speculative_shrink(self, graph: Graph, ext: np.ndarray,
                            cand_mask: np.ndarray, cursor: int) -> _Prefetch:
        """Shrink ``graph`` as if EVERY candidate of part ``cursor``
        finalizes: the speculation of the overlap prefetch (depth 1, on the
        worker) and of the wave planner (depth ``part_parallel``, on the
        main thread)."""
        t0 = time.perf_counter()
        stats = self._fresh_stats()
        keep_local = ~cand_mask
        ext_delta = self._fold_external(graph, keep_local, cand_mask, stats)
        shrink_graph, keep_ids = induced_subgraph(
            graph, keep_local, chunk_slots=self.divide_chunk, stats=stats,
            device=self.divide_device,
        )
        ext_next = ext[keep_local] + ext_delta
        return _Prefetch(
            base_cursor=cursor, shrink_graph=shrink_graph,
            shrink_keep_ids=keep_ids, ext_next=ext_next,
            shrink_stats=stats, shrink_time_s=time.perf_counter() - t0,
        )

    def _prefetch_task(self, graph: Graph, ext: np.ndarray,
                       cand_mask: np.ndarray, cursor: int) -> _Prefetch:
        """The worker's task: numpy and bucketize only, no CUDA call."""
        self._visit_fault("prefetch", cursor=cursor)
        pf = self._speculative_shrink(graph, ext, cand_mask, cursor)
        pf.plan = self._plan_on(
            pf.shrink_graph, pf.ext_next, cursor + 1, speculative=True
        )
        if pf.plan is not None:
            self._bucketize(pf.plan)
        return pf

    def _take_prefetch(self, cursor: int) -> Optional[_Prefetch]:
        """Join the in-flight prefetch (if any). Worker failures re-raise
        here -- a broken divide pass is a real failure, not a missed bet."""
        if self._future is None:
            return None
        fut, self._future = self._future, None
        pf = fut.result()
        return pf if pf.base_cursor == cursor else None

    # ---------------- conquer stage ---------------- #
    @spanned("repro_torch.dckcore.conquer")
    def _conquer(self, plan: PartPlan, fn: Optional[DecomposeFn] = None,
                 lead: bool = True, account: bool = True, heartbeat=None):
        """Conquer one part; returns ``(result, bitmap density, start
        sweep)``. A pending sweep snapshot that belongs to this part warm
        restarts it; with ``sweep_checkpoint_every`` the engine's
        ``on_sweep`` hook saves a snapshot every that many sweeps.

        ``fn`` overrides the engine (a slice's decompose). ``lead=False``
        (a wave's later parts) skips the pending snapshot and the snapshot
        hook: only the part the boundary checkpoint points at writes
        snapshots, so a crashed wave leaves the disk a sequential run
        crashed in that part would. ``account=False`` leaves the
        preprocess-time accounting to the main thread. ``heartbeat`` (the
        watchdog's liveness callable) is composed into ``on_sweep``; alone
        it reads nothing of the estimates, so no sweep copies them to the
        host for it."""
        state = self.state
        t0 = time.perf_counter()
        init = None
        start_sweep = 0
        if lead and self.pending_snap is not None:
            snap = self.pending_snap
            if snap.matches(state, plan.cursor, plan.part_g.n_nodes,
                            plan.threshold):
                init = snap.coreness
                start_sweep = snap.sweep
            else:
                # Stale (e.g. a crash between a boundary save and the
                # sweeps purge): remove it so it cannot shadow this run's
                # snapshots on a later resume.
                self._purge_sweeps()
            # One shot: a snapshot can only belong to the first part a
            # resumed run executes.
            self.pending_snap = None
        hook = None
        if lead and self.sweep_checkpoint_every is not None:
            every = max(1, int(self.sweep_checkpoint_every))
            last = {"c": None if init is None else np.asarray(init)}

            def hook(it, coreness):
                if it % every:
                    return
                # The engine's view is a tensor on its device, made on this
                # thread's current stream (a slice's own on the card), which
                # this copy runs on too.
                c = coreness.cpu().numpy().astype(np.int32, copy=False)
                if last["c"] is not None and np.array_equal(last["c"], c):
                    return  # fixed point (or no progress): nothing to save
                save_s = SweepSnapshot(
                    coreness=c, parts_done=plan.cursor, sweep=start_sweep + it,
                    n_part=plan.part_g.n_nodes, threshold=plan.threshold,
                    thresholds=state.thresholds, fingerprint=state.fingerprint,
                ).save(self.sweeps_mgr, blocking=not self.overlap)
                last["c"] = c
                if self.on_sweep_saved is not None:
                    self.on_sweep_saved(plan.cursor, start_sweep + it, save_s)

        if heartbeat is not None:
            inner = hook

            def hook(it, coreness, _inner=inner):
                heartbeat()
                if _inner is not None:
                    _inner(it, coreness)

        if account:
            self.preprocess_time_s += (
                (time.perf_counter() - t0) + plan.bucketize_time_s + plan.extract_time_s
            )
        fn = fn if fn is not None else self.decompose_fn
        if init is not None or hook is not None:
            res = fn(plan.bg, init_coreness=init, on_sweep=hook)
        else:
            res = fn(plan.bg)
        return res, bitmap_density(plan.bg), start_sweep

    # ---------------- merge + shrink ---------------- #
    def _report_for(self, plan: PartPlan, res, density: float,
                    start_sweep: int, finalized: int) -> PartReport:
        return PartReport(
            name=plan.name,
            threshold=plan.threshold,
            n_nodes=plan.part_g.n_nodes,
            n_edges=plan.part_g.n_edges,
            iterations=res.iterations,
            comm_amount=res.comm_amount,
            peak_bytes=res.peak_bytes,
            extract_time_s=plan.extract_time_s,
            decompose_time_s=res.wall_time_s,
            finalized=finalized,
            gathered_rows=res.gathered_rows,
            full_sweep_rows=res.full_sweep_rows,
            active_rows_per_iter=list(res.active_rows_per_iter),
            collective_bytes=res.collective_bytes,
            bitmap_density=density,
            resumed_at_sweep=start_sweep,
            prefetched=plan.speculative,
        )

    @spanned("repro_torch.dckcore.merge")
    def _finalize_threshold(self, plan: PartPlan, res, density: float,
                            start_sweep: int):
        """Merge a threshold part's result into the global state and
        append its report (before the shrink)."""
        state = self.state
        # Finalize nodes that resolved at >= t (all of them for Exact-Divide).
        final_local = res.coreness >= plan.threshold
        part_orig_ids = state.remaining_ids[plan.part_local_ids]
        newly = part_orig_ids[final_local]
        state.coreness[newly] = res.coreness[final_local]
        state.finalized[newly] = True
        report = self._report_for(plan, res, density, start_sweep,
                                  int(final_local.sum()))
        self.parts.append(report)
        return report, final_local

    def _shrink(self, plan: PartPlan, final_local: np.ndarray,
                report: PartReport) -> Optional[PartPlan]:
        """Fold the finalized nodes out of the remaining graph. Adopts the
        speculative shrink when the prediction held (byte-identical: the
        masks coincide and every divide pass is deterministic); otherwise
        discards it and recomputes synchronously, exactly as the
        sequential path. Returns the prefetched next plan on a hit."""
        pf = self._take_prefetch(plan.cursor)
        if pf is not None and bool(final_local.all()):
            self.prefetch_hits += 1
            self._adopt_shrink(plan, pf, report)
            return pf.plan
        if pf is not None:
            self.prefetch_misses += 1
        self._shrink_sync(plan, final_local, report)
        return None

    def _adopt_shrink(self, plan: PartPlan, pf: _Prefetch,
                      report: PartReport) -> None:
        """Adopt a validated speculative shrink."""
        state = self.state
        plan.dstats.merge(pf.shrink_stats)
        state.ext_remaining = pf.ext_next
        state.remaining_ids = state.remaining_ids[pf.shrink_keep_ids]
        self.remaining_graph = pf.shrink_graph
        self.preprocess_time_s += pf.shrink_time_s
        report.divide_transient_bytes = plan.dstats.peak_transient_bytes

    @spanned("repro_torch.dckcore.shrink")
    def _shrink_sync(self, plan: PartPlan, final_local: np.ndarray,
                     report: PartReport) -> None:
        """The sequential fold: shrink the remaining graph by the part's
        ACTUALLY finalized nodes; E(v) of the kept nodes grows by their
        finalized neighbors."""
        state = self.state
        t0 = time.perf_counter()
        newly_mask_local = np.zeros(self.remaining_graph.n_nodes, dtype=bool)
        newly_mask_local[plan.part_local_ids[final_local]] = True
        keep_local = ~newly_mask_local
        ext_delta = self._fold_external(
            self.remaining_graph, keep_local, newly_mask_local, plan.dstats
        )
        new_graph, keep_ids = induced_subgraph(
            self.remaining_graph, keep_local,
            chunk_slots=self.divide_chunk, stats=plan.dstats,
            device=self.divide_device,
        )
        state.ext_remaining = state.ext_remaining[keep_local] + ext_delta
        state.remaining_ids = state.remaining_ids[keep_ids]
        self.remaining_graph = new_graph
        self.preprocess_time_s += time.perf_counter() - t0
        report.divide_transient_bytes = plan.dstats.peak_transient_bytes

    @spanned("repro_torch.dckcore.merge")
    def _merge_rest(self, plan: PartPlan, res, density: float,
                    start_sweep: int, annotate=None) -> None:
        state = self.state
        state.coreness[state.remaining_ids] = res.coreness
        state.finalized[state.remaining_ids] = True
        report = self._report_for(plan, res, density, start_sweep,
                                  plan.part_g.n_nodes)
        if annotate is not None:
            annotate(report)  # wave / slice stamps, before the report is saved
        self.parts.append(report)
        state.remaining_ids = np.zeros(0, dtype=np.int64)
        state.ext_remaining = np.zeros(0, dtype=np.int32)
        state.complete = True
        self._checkpoint_boundary(report)

    # ---------------- checkpoint stage ---------------- #
    def _purge_sweeps(self) -> None:
        if self.sweeps_mgr is not None:
            self.sweeps_mgr.clear_steps()

    def _checkpoint_boundary(self, report: Optional[PartReport]) -> None:
        """Save state at a part boundary, then fire the hook. The finished
        part's sweep snapshots are purged after the boundary save (a crash
        between the two is caught by snapshot validation)."""
        if self.state_mgr is not None:
            self._visit_fault("checkpoint_save",
                              parts_done=int(self.state.parts_done))
            on_done = None
            if report is not None:
                def on_done(_step, secs, _r=report):
                    _r.save_wall_s = secs
            blocked = self.state.save(self.state_mgr, blocking=not self.overlap,
                                      on_done=on_done)
            self._purge_sweeps()
            if report is not None:
                report.save_time_s = blocked
        if self.on_part_done is not None and report is not None:
            self.on_part_done(len(self.parts) - 1, report)

    # ---------------- part-parallel waves ---------------- #
    def _wave_width(self) -> int:
        """Parts planned per wave: the slice count minus the blacklisted
        slices (a degraded run plans narrower waves; at width 1 it is the
        sequential loop)."""
        return max(1, (self.part_parallel or 1) - len(self.blacklisted))

    def _plan_wave(self, first_plan: PartPlan):
        """Plan up to ``part_parallel`` consecutive parts (minus the
        blacklisted slices) by chaining speculative shrinks: part ``i+1`` is
        planned on the PREDICTED shrink of part ``i`` (every candidate
        finalizes). Returns ``(wave, shrinks)`` with ``shrinks[i]`` the
        speculative shrink that applies after ``wave[i]`` (``None`` for
        empty parts and for the un-speculated last entry). Main thread,
        host work only."""
        wave = [first_plan]
        shrinks: List[Optional[_Prefetch]] = [None]
        graph, ext = self.remaining_graph, self.state.ext_remaining
        while len(wave) < self._wave_width() and not wave[-1].is_rest:
            cur = wave[-1]
            if not cur.is_empty:
                pf = self._speculative_shrink(graph, ext, cur.cand_mask,
                                              cur.cursor)
                shrinks[-1] = pf
                graph, ext = pf.shrink_graph, pf.ext_next
            nxt = self._plan_on(graph, ext, cur.cursor + 1, speculative=True)
            if nxt is None:
                break  # the predicted shrink emptied the graph: no rest part
            wave.append(nxt)
            shrinks.append(None)
        for p in wave:
            self._bucketize(p)
        return wave, shrinks

    def _slice_stream(self, s: int):
        """Slice ``s``'s CUDA stream as the calling thread's current stream
        (nothing off the card). The kernels launch on the current stream
        and a part's tensors are made and read on it, so a slice's parts
        never touch another slice's memory or wait on its work."""
        if self.slice_streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.slice_streams[s])

    def _exchange(self, schedule, own_results: Dict[int, tuple],
                  error: Optional[BaseException]) -> Dict[int, tuple]:
        """Rank slices: hand every part's result from its slice's first rank
        to every rank over the whole plan's world group, in cursor order.
        A slice's failure travels the same way (in place of the results it
        did not produce), so every rank raises the earliest cursor's error
        instead of waiting on a broadcast. The busy seconds of each slice
        are taken from the broadcast results, so every rank reports the
        same ``slice_busy_s``."""
        import torch.distributed as dist

        me = self.fold_plan.ranks[self.fold_plan.rank]
        group = self.fold_plan.world_group
        out: Dict[int, tuple] = {}
        first_error = None
        for a in schedule.assignments:
            src = self.slice_plans[a.slice_index].ranks[0]
            box = [own_results.get(a.cursor, error) if src == me else None]
            if group is not None:
                dist.broadcast_object_list(box, src=src, group=group)
            if isinstance(box[0], BaseException) or box[0] is None:
                first_error = first_error or box[0] or RuntimeError(
                    f"rank slice {a.slice_index} returned no result for part "
                    f"cursor={a.cursor}")
                continue
            out[a.cursor] = box[0]
            self.slice_busy_s[a.slice_index] += box[0][0].wall_time_s
        if first_error is not None:
            raise first_error
        return out

    def _run_wave(self, wave: List[PartPlan],
                  shrinks: List[Optional[_Prefetch]]) -> Optional[PartPlan]:
        """Conquer one wave across the slices, then merge strictly in plan
        order. Returns the next wave's first plan (``None`` = done).

        The LPT schedule places each non-empty part on a slice by its
        modeled cost; every slice conquers its parts concurrently on its
        own worker thread (and stream, on the card); only the lead part
        consults or writes sweep snapshots. On rank slices this rank runs
        only its own slice's worker and receives the other parts' results
        (:meth:`_exchange`). The merge loop then validates each speculation
        in plan order: on a hit the predicted shrink is adopted
        (byte-identical to the sequential fold), on a miss the sync fold
        runs and every later speculative conquer of the wave is discarded,
        as the sequential loop would have recomputed them. With a watchdog
        the wave is fault-tolerant (retry, blacklist, re-plan); its
        telemetry folds into the run report."""
        from repro_torch.core.partsched import (
            WaveSchedule,
            WaveTelemetry,
            assign_parts,
            conquer_wave,
            cost_for_plan,
        )

        state = self.state
        surviving = [
            sp for sp in self.slice_specs if sp.index not in self.blacklisted
        ]
        live = [p for p in wave if not p.is_empty]
        costs = [
            cost_for_plan(p.bg, p.cursor, surviving[0]) for p in live
        ]
        schedule = assign_parts(costs, surviving)
        # Divide-side accounting for the whole wave, booked on the main
        # thread before the slice threads start (_conquer(account=False)).
        self.preprocess_time_s += sum(
            p.bucketize_time_s + p.extract_time_s for p in wave
        )
        lead_cursor = min((p.cursor for p in live), default=None)
        by_cursor = {p.cursor: p for p in live}
        assign_of = {a.cursor: a for a in schedule.assignments}

        def _run_one(cursor: int, s: int, heartbeat=None):
            plan = by_cursor[cursor]
            fn = (
                self.slice_decomposes[s]
                if self.slice_decomposes is not None else None
            )
            with self._slice_stream(s):
                out = self._conquer(
                    plan, fn=fn, lead=(cursor == lead_cursor), account=False,
                    heartbeat=heartbeat,
                )
            if self.slice_plans is None:
                # Only slice ``s``'s worker writes index ``s``: no lock.
                self.slice_busy_s[s] += out[0].wall_time_s
            return out

        if self.watchdog is not None:
            run_part = _run_one
        else:
            # Fail-fast: the two-argument call (no heartbeat composed into
            # on_sweep), so a custom decompose_fn without kwargs still works.
            def run_part(cursor: int, s: int):
                return _run_one(cursor, s)

        tel = WaveTelemetry()
        t0 = time.perf_counter()
        try:
            if self.slice_plans is None:
                results = conquer_wave(
                    schedule, run_part, slices=surviving, watchdog=self.watchdog,
                    fault_plan=self.fault_plan, telemetry=tel,
                )
            else:
                mine = next(i for i, p in enumerate(self.slice_plans) if p.rank >= 0)
                own = WaveSchedule(
                    [a for a in schedule.assignments if a.slice_index == mine],
                    schedule.n_slices,
                )
                own_results, error = {}, None
                try:
                    own_results = conquer_wave(
                        own, run_part, slices=[self.slice_specs[mine]],
                        fault_plan=self.fault_plan, telemetry=tel,
                    )
                except Exception as exc:  # noqa: BLE001 -- sent to every rank
                    error = exc
                results = self._exchange(schedule, own_results, error)
        finally:
            self.conquer_wall_s += time.perf_counter() - t0
            self.retries += tel.retries
            self.replans += tel.replans
            if tel.blacklisted:
                self.degraded_waves += 1
                self.blacklisted.update(tel.blacklisted)
            self.fault_events.extend(tel.events)
        retries_of: Dict[int, int] = {}
        for e in tel.events:
            if e.get("event") == "retry":
                retries_of[e["cursor"]] = retries_of.get(e["cursor"], 0) + 1

        for i, plan in enumerate(wave):
            if plan.is_empty:
                state.parts_done = plan.cursor + 1
                self._checkpoint_boundary(None)
                continue
            res, density, start_sweep = results[plan.cursor]
            a = assign_of[plan.cursor]

            def stamp(r, _a=a):
                # slice_index is the PLANNED placement; a re-planned part's
                # actual slice is in the replan event.
                r.slice_index = _a.slice_index
                r.wave = self._wave_index
                r.modeled_cost_bytes = _a.cost.total
                r.retries = retries_of.get(_a.cursor, 0)

            if plan.is_rest:
                self._merge_rest(plan, res, density, start_sweep,
                                 annotate=stamp)
                return None
            report, final_local = self._finalize_threshold(
                plan, res, density, start_sweep
            )
            stamp(report)
            pf = shrinks[i]
            if pf is not None and bool(final_local.all()):
                self.prefetch_hits += 1
                self._adopt_shrink(plan, pf, report)
                state.parts_done = plan.cursor + 1
                self._checkpoint_boundary(report)
                continue
            # Miss (or the wave's un-speculated tail): fold synchronously,
            # discard every later speculative conquer of this wave.
            if pf is not None:
                self.prefetch_misses += 1
                self.speculation_discards += sum(
                    1 for p in wave[i + 1:] if not p.is_empty
                )
            self._shrink_sync(plan, final_local, report)
            state.parts_done = plan.cursor + 1
            self._checkpoint_boundary(report)
            if pf is not None and i < len(wave) - 1:
                return self._build_plan(plan.cursor + 1)
        return self._build_plan(wave[-1].cursor + 1)

    def run_waves(self) -> None:
        state = self.state
        plan = self._build_plan(state.parts_done)
        while plan is not None:
            wave, shrinks = self._plan_wave(plan)
            plan = self._run_wave(wave, shrinks)
            self._wave_index += 1
        if not state.complete:
            # The shrink emptied the graph before the rest part.
            state.complete = True
            self._checkpoint_boundary(None)

    # ---------------- scheduler ---------------- #
    def run(self) -> None:
        if self.part_parallel is not None:
            self.run_waves()
            return
        state = self.state
        plan = self._build_plan(state.parts_done)
        while plan is not None:
            if plan.is_empty:
                # No candidates at this threshold: consume the cursor.
                state.parts_done = plan.cursor + 1
                self._checkpoint_boundary(None)
                plan = self._build_plan(plan.cursor + 1)
                continue
            self._bucketize(plan)
            self._submit_prefetch(plan)
            res, density, start_sweep = self._conquer(plan)
            if plan.is_rest:
                self._merge_rest(plan, res, density, start_sweep)
                plan = None
                continue
            report, final_local = self._finalize_threshold(
                plan, res, density, start_sweep)
            next_plan = self._shrink(plan, final_local, report)
            state.parts_done = plan.cursor + 1
            self._checkpoint_boundary(report)
            if next_plan is None:
                next_plan = self._build_plan(plan.cursor + 1)
            plan = next_plan
        if not state.complete:
            # The shrink emptied the graph before the rest part.
            state.complete = True
            self._checkpoint_boundary(None)

    def close(self, suppress_errors: bool = False) -> None:
        """Drain the prefetch worker and both checkpoint managers. Runs on
        EVERY exit path: after a crash-by-exception the pending async saves
        land before the exception leaves ``dc_kcore``, so the on-disk state
        at "crash" time is deterministic and no worker thread outlives the
        call."""
        if self._future is not None:
            fut, self._future = self._future, None
            exc = fut.exception()  # waits; consumes a worker failure
            if exc is not None and not suppress_errors:
                raise exc
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        for mgr in (self.state_mgr, self.sweeps_mgr):
            if mgr is None:
                continue
            try:
                mgr.wait()
            except BaseException:
                if not suppress_errors:
                    raise


# Kernel libraries each built-in engine launches (kernels/build.py SOURCES).
_ENGINE_KERNELS = {"fused": ("fused",), "kernel": ("hindex",)}


def _prepare_card(names, n_slices: int, device) -> Optional[list]:
    """On a CUDA device: build and load the kernel libraries ``names`` before
    the first wave (an ``nvcc`` build inside a part would stall its slice's
    heartbeat past a watchdog's timeout) and make one CUDA stream per slice.
    ``None`` off the card."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    if names:
        from repro_torch.kernels import build

        build.build(names)
        for name in names:
            build.load(name)
    return [torch.cuda.Stream(device=dev) for _ in range(n_slices)]


@spanned("repro_torch.dckcore")
def dc_kcore(
    g: Graph,
    thresholds: Sequence[int] = (),
    strategy: str = "rough",
    decompose_fn: Optional[DecomposeFn] = None,
    row_align: int = 8,
    reorder: str = "identity",
    max_bucket_rows="auto",
    reorder_sample_edges: Optional[int] = None,
    on_part_done: Optional[PartHook] = None,
    divide_chunk: Optional[int] = None,
    engine: str = "sorted",
    int16: bool = False,
    device="cuda",
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    sweep_checkpoint_every: Optional[int] = None,
    on_sweep_saved: Optional[SweepSavedHook] = None,
    ckpt_retain: int = 2,
    overlap: bool = False,
    part_parallel: Optional[int] = None,
    part_parallel_plan=None,
    slice_capacity_bytes: Optional[int] = None,
    slice_timeout_s: Optional[float] = None,
    max_retries: Optional[int] = None,
    retry_backoff_s: float = 0.05,
    fault_plan=None,
    divide_device=None,
) -> tuple[np.ndarray, DCKCoreReport]:
    """Run DC-kCore. ``thresholds=()`` degenerates to the monolithic baseline
    (= the PSGraph competitor in the paper's tables).

    ``engine`` selects the built-in conquer engine's sweep op
    (``"sorted"`` / ``"count"`` / ``"kernel"`` / ``"fused"`` -- see
    :func:`repro_torch.core.decompose.decompose`), ``int16`` opts the fused
    engine into the halved-width estimate mode (overflow-guarded), and
    ``device`` is where it sweeps (default ``"cuda"``; without a GPU that
    raises -- pass ``"cpu"`` to run on the CPU). All three apply only when
    ``decompose_fn`` is not given: a custom engine owns its own
    configuration (``make_distributed_decompose`` builds the distributed
    one), so combining them raises. With sweep snapshots a custom engine
    is called as ``decompose_fn(bg, init_coreness=..., on_sweep=...)``.

    ``reorder`` (``"identity"`` / ``"bfs"`` / ``"rcm"``) applies a
    locality-aware node ordering to *each part* before bucketizing it;
    ``reorder_sample_edges`` computes it from a bounded edge sample.
    ``max_bucket_rows`` is forwarded to
    :func:`~repro_torch.graph.build.bucketize` (``"auto"`` = the
    degree-profile tile autotuner). ``divide_chunk`` bounds the divide
    step's transient host bytes (``None`` = the built-in budget).
    ``on_part_done`` (``hook(part_index, report)``) fires after each
    part's checkpoint save.

    ``checkpoint_dir`` saves the :class:`PipelineState` atomically after
    every part; ``resume=True`` restores the latest intact checkpoint and
    re-enters at the first unfinished part, with coreness byte-identical to
    the uninterrupted run. ``sweep_checkpoint_every=k`` (requires
    ``checkpoint_dir``) also saves a :class:`SweepSnapshot` every ``k``
    sweeps, and ``resume=True`` with the flag set re-enters mid-part;
    ``on_sweep_saved`` (``hook(part_cursor, sweep, save_seconds)``) fires
    after each snapshot save. ``ckpt_retain`` is the number of newest
    boundary and snapshot steps kept (default 2: a corrupted latest step,
    detected by its per-leaf CRC32 and quarantined to ``step_*.corrupt``,
    falls back to its predecessor).

    ``overlap=True`` pipelines the stages: one worker thread runs the next
    part's divide passes and bucketize (and the shrink of the current
    remaining graph) while the current part sweeps on the device, and
    checkpoint saves go through the managers' async threads. The prefetch
    is speculative -- it assumes every candidate of the conquering part
    finalizes -- and is validated against the actual finalized set before
    being adopted, recomputed synchronously on a miss (Exact-Divide always
    hits). Coreness is **byte-identical** with the flag on or off, resume
    included; only the wall clock and :attr:`DCKCoreReport.idle_fraction`
    change. ``on_part_done`` fires after the save is *enqueued* in that
    mode; a crash raised from it still drains the pending save first.

    ``part_parallel=S`` conquers up to ``S`` consecutive parts CONCURRENTLY
    per wave: the wave planner chains speculative shrinks, the scheduler
    (:mod:`repro_torch.core.partsched`) places each part on a slice by its
    modeled collective + memory cost, and the merge validates the
    predictions strictly in plan order, discarding the wave's tail on the
    first miss. Coreness, reports, checkpoints, sweep snapshots and resume
    are **byte-identical** to the sequential path. Without
    ``part_parallel_plan`` the slices are worker threads sharing the
    configured engine, each on its own CUDA stream when ``device`` is a
    CUDA device (the kernels are built before the first wave). With it (a
    :class:`~repro_torch.core.distributed.MeshPlan` over a process group;
    every rank calls ``dc_kcore`` with the same arguments) the plan is split
    into ``S`` rank slices along its first node axis, each part sweeps on
    its slice's distributed engine (with the counts kernel on ``device``),
    each rank receives
    the other slices' results from their first ranks, and the E(v) boundary
    folds run over the whole plan
    (:attr:`DCKCoreReport.boundary_exchange_bytes`). Every rank then merges
    and checkpoints the same way, so with ``checkpoint_dir`` each rank
    needs a directory of its own. ``slice_capacity_bytes`` bounds each
    slice's modeled resident bytes (the scheduler refuses oversized parts
    with :class:`~repro_torch.core.partsched.SliceCapacityError`).
    Mutually exclusive with ``overlap``: the wave subsumes the prefetch.

    ``slice_timeout_s`` / ``max_retries`` (require ``part_parallel``) make
    the wave executor fault-TOLERANT: a failed part retries on its slice
    with exponential backoff (``retry_backoff_s`` base) up to
    ``max_retries`` times; a slice whose sweep heartbeat stalls past
    ``slice_timeout_s``, or that runs out of retries, is blacklisted for
    the rest of the run and its parts re-plan over the surviving slices
    (S -> S-1 -> ... -> 1). Parts are idempotent over immutable inputs, so a
    degraded run's coreness stays byte-identical; retries, blacklists and
    degraded waves land in the report. Without either knob a slice failure
    re-raises after the wave drains. The watchdog on rank slices is not
    ported (a crashed or hung rank leaves its slice's collectives waiting;
    ``ROADMAP.md``, queue 1) and raises :class:`NotImplementedError`.

    ``fault_plan`` (a :class:`repro_torch.runtime.FaultPlan`) injects
    crashes, hangs and slowdowns into the named sites ``slice_conquer``,
    ``boundary_fold``, ``checkpoint_save`` and ``prefetch``; the run drains
    its workers and its pending saves, releases injected hangs and
    re-raises.

    ``divide_device`` (a torch device; ``None`` = numpy on the host) runs
    the divide passes there: Exact-Divide's peel, the induced subgraphs
    and the E(v) fold, each over the whole remaining graph at once, to the
    same parts and coreness. Their slots are counted in each part's
    ``DivideStats``, their device scratch is not, so
    ``divide_transient_bytes`` reads 0. Rough-Divide's mask and the
    layout stay on the host. It runs them on the calling thread, so it
    excludes ``overlap`` and ``part_parallel``.
    """
    if divide_device is not None and (overlap or part_parallel is not None):
        raise ValueError("divide_device runs the divide passes on the calling "
                         "thread; overlap and part_parallel run them on "
                         "worker threads")
    slice_decomposes = slice_specs = slice_plans = fold_plan = None
    if part_parallel is not None:
        if part_parallel < 1:
            raise ValueError(f"part_parallel must be >= 1, got {part_parallel}")
        if overlap:
            raise ValueError("part_parallel subsumes overlap (the wave IS "
                             "the speculation) — pass one or the other")
        if part_parallel_plan is not None:
            if decompose_fn is not None:
                raise ValueError("part_parallel_plan builds one distributed "
                                 "engine per mesh slice — decompose_fn would "
                                 "be silently ignored")
            if engine != "sorted" or int16:
                raise ValueError("part_parallel_plan selects the distributed "
                                 "engine; engine=/int16= would be silently "
                                 "ignored")
            if slice_timeout_s is not None or max_retries is not None:
                raise NotImplementedError(
                    "slice_timeout_s/max_retries on rank slices "
                    "(part_parallel_plan) are not ported: a crashed or hung "
                    "rank leaves its slice's collectives waiting, and a "
                    "blacklist across ranks is a design of its own "
                    "(ROADMAP.md, queue 1, \"the watchdog on rank slices\")")
            from repro_torch.core.partsched import make_slice_decomposes, spec_of

            slice_plans, slice_decomposes = make_slice_decomposes(
                part_parallel_plan, part_parallel, use_kernel=True, device=device,
            )
            slice_specs = [
                spec_of(p, i, slice_capacity_bytes)
                for i, p in enumerate(slice_plans)
            ]
            fold_plan = part_parallel_plan
        else:
            from repro_torch.core.partsched import SliceSpec

            slice_specs = [
                SliceSpec(i, 1, 1, slice_capacity_bytes)
                for i in range(part_parallel)
            ]
    elif part_parallel_plan is not None:
        raise ValueError("part_parallel_plan requires part_parallel")
    watchdog = None
    if slice_timeout_s is not None or max_retries is not None:
        if part_parallel is None:
            raise ValueError("slice_timeout_s/max_retries configure the "
                             "part-parallel wave watchdog — they require "
                             "part_parallel")
        from repro_torch.core.partsched import WatchdogConfig

        watchdog = WatchdogConfig(
            slice_timeout_s=slice_timeout_s,
            max_retries=2 if max_retries is None else int(max_retries),
            backoff_s=float(retry_backoff_s),
        )
    if ckpt_retain < 1:
        raise ValueError(f"ckpt_retain must be >= 1, got {ckpt_retain}")
    # The kernel libraries the slices launch (none known for a custom engine).
    slice_kernels = ("counts",) if part_parallel_plan is not None else ()
    if decompose_fn is None:
        slice_kernels += _ENGINE_KERNELS.get(engine, ())
        decompose_fn = (  # noqa: E731
            lambda bg, **kw: decompose(bg, op=engine, int16=int16, device=device, **kw)
        )
    elif engine != "sorted" or int16 or device != "cuda":
        raise ValueError("engine=/int16=/device= configure the built-in "
                         "engine; with decompose_fn they would be silently "
                         "ignored -- configure the custom engine instead")
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True requires checkpoint_dir")
    if sweep_checkpoint_every is not None and checkpoint_dir is None:
        raise ValueError("sweep_checkpoint_every requires checkpoint_dir")
    thresholds = sorted(set(int(t) for t in thresholds), reverse=True)
    t_start = time.perf_counter()

    n = g.n_nodes
    state: Optional[PipelineState] = None
    resumed_parts = 0
    pending_snap: Optional[SweepSnapshot] = None
    # Quarantine records of corrupt-checkpoint fallbacks during restore.
    restore_events: List[dict] = []
    if resume:
        state = PipelineState.restore(checkpoint_dir, n, events=restore_events)
        if sweep_checkpoint_every is not None:
            # Mid-part resume point, consulted even when no part boundary
            # exists yet (a run killed during part 0), and validated
            # against its part when that part runs.
            pending_snap = SweepSnapshot.restore(_sweep_dir(checkpoint_dir),
                                                 events=restore_events)
    state_mgr = sweeps_mgr = None
    if checkpoint_dir is not None:
        from repro_torch.ckpt import CheckpointManager

        state_mgr = CheckpointManager(checkpoint_dir, retain=ckpt_retain)
        sweeps_mgr = CheckpointManager(_sweep_dir(checkpoint_dir), retain=ckpt_retain)
    if state is None:
        if checkpoint_dir is not None and not resume:
            # Fresh run: purge stale steps (and sweep snapshots) of any
            # previous run in this dir.
            state_mgr.clear_steps()
            sweeps_mgr.clear_steps()
        state = PipelineState.fresh(g, thresholds)
        remaining_graph = g
    else:
        if state.fingerprint != graph_fingerprint(g):
            raise ValueError(
                f"checkpoint was written for a different graph "
                f"(fingerprint {state.fingerprint} != {graph_fingerprint(g)})"
            )
        if state.thresholds != thresholds:
            raise ValueError(
                f"checkpoint plans thresholds {state.thresholds}, "
                f"this run asked for {thresholds}"
            )
        resumed_parts = len(state.reports)
        if state.complete:
            report = DCKCoreReport(
                parts=state.reports,
                total_time_s=time.perf_counter() - t_start,
                preprocess_time_s=0.0,
                resumed_parts=resumed_parts,
                overlap=overlap,
                part_parallel=part_parallel or 0,
                quarantined_steps=len(restore_events),
                fault_events=list(restore_events),
            )
            return state.coreness.copy(), report
        # Rebuild the remaining graph from the original + finalized mask
        # (induced-subgraph composition is byte-stable).
        remaining_graph, keep_ids = induced_subgraph(
            g, ~state.finalized, chunk_slots=divide_chunk, device=divide_device
        )
        if not np.array_equal(keep_ids, state.remaining_ids):
            raise ValueError("checkpoint remaining-id map inconsistent with "
                             "its finalized mask")

    slice_streams = None
    if part_parallel is not None:
        slice_streams = _prepare_card(slice_kernels, part_parallel, device)
    pipeline = _PartPipeline(
        state=state,
        remaining_graph=remaining_graph,
        thresholds=thresholds,
        strategy=strategy,
        decompose_fn=decompose_fn,
        row_align=row_align,
        reorder=reorder,
        max_bucket_rows=max_bucket_rows,
        reorder_sample_edges=reorder_sample_edges,
        divide_chunk=divide_chunk,
        on_part_done=on_part_done,
        sweep_checkpoint_every=sweep_checkpoint_every,
        on_sweep_saved=on_sweep_saved,
        pending_snap=pending_snap,
        state_mgr=state_mgr,
        sweeps_mgr=sweeps_mgr,
        overlap=overlap,
        fault_plan=fault_plan,
        part_parallel=part_parallel,
        slice_decomposes=slice_decomposes,
        slice_specs=slice_specs,
        slice_plans=slice_plans,
        slice_streams=slice_streams,
        fold_plan=fold_plan,
        device=device,
        watchdog=watchdog,
        divide_device=divide_device,
    )
    try:
        pipeline.run()
    except BaseException:
        # Crash-by-exception (the fault-injection hooks included): release
        # injected hangs, drain the worker and pending saves FIRST, so the
        # disk state the crashed run leaves is deterministic, then let the
        # crash propagate.
        if fault_plan is not None:
            fault_plan.release()
        pipeline.close(suppress_errors=True)
        raise
    if fault_plan is not None:
        fault_plan.release()
    pipeline.close()

    report = DCKCoreReport(
        parts=pipeline.parts,
        total_time_s=time.perf_counter() - t_start,
        preprocess_time_s=pipeline.preprocess_time_s,
        resumed_parts=resumed_parts,
        overlap=overlap,
        prefetch_hits=pipeline.prefetch_hits,
        prefetch_misses=pipeline.prefetch_misses,
        part_parallel=part_parallel or 0,
        conquer_wall_s=pipeline.conquer_wall_s,
        slice_busy_s=list(pipeline.slice_busy_s),
        speculation_discards=pipeline.speculation_discards,
        boundary_exchange_bytes=pipeline.boundary_exchange_bytes,
        retries=pipeline.retries,
        blacklisted_slices=sorted(pipeline.blacklisted),
        degraded_waves=pipeline.degraded_waves,
        quarantined_steps=len(restore_events),
        fault_events=list(restore_events) + list(pipeline.fault_events),
    )
    if not bool((state.coreness >= 0).all()):
        raise MergeIncompleteError(
            f"merge left {int((state.coreness < 0).sum())} of {n} nodes "
            f"unfinalized -- every node must be resolved by exactly one part"
        )
    return state.coreness, report
