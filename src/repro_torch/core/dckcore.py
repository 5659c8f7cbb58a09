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

This is the port of the JAX package's ``repro.core.dckcore`` on its
sequential path; the per-part reports are field-for-field the same. The
overlapped prefetch pipeline, part-parallel waves and the fault-tolerance
layer are later slices of the port (``ROADMAP.md``, "Modules to port");
their options raise :class:`NotImplementedError` here.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

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

STATE_FORMAT = 1
SWEEP_FORMAT = 1


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
    # Checkpoint steps quarantined as corrupt during restore, and their
    # records ({"event": "quarantine", ...}).
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
        """Wall time the pipeline was blocked on per-part checkpoint saves."""
        return sum(p.save_time_s for p in self.parts)

    @property
    def total_save_wall_s(self) -> float:
        """Wall time of the completed per-part saves."""
        return sum(p.save_wall_s for p in self.parts)

    @property
    def total_decompose_time_s(self) -> float:
        """Wall time the conquer engine was actually sweeping."""
        return sum(p.decompose_time_s for p in self.parts)

    @property
    def idle_fraction(self) -> float:
        """Fraction of the run's wall clock the device spent NOT sweeping
        (divide passes, bucketize, merge)."""
        if self.total_time_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self.total_decompose_time_s / self.total_time_s)


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

    def save(self, manager,
             on_done: Optional[Callable[[int, float], None]] = None) -> float:
        """Blocking atomic save at the current part boundary through
        ``manager`` (a :class:`~repro_torch.ckpt.CheckpointManager`, which
        keeps its ``retain`` newest steps); returns its wall seconds.

        Step number = parts completed so far (the rest part counts one
        past the last threshold), so ``latest_step`` is the cursor. A
        part's own save time is known only after its save, so it is
        persisted one boundary later."""
        t0 = time.perf_counter()
        step = self.parts_done + (1 if self.complete else 0)
        manager.save(self.arrays(), step, extra=self.extra(),
                     blocking=True, on_done=on_done)
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

    def save(self, manager) -> float:
        """Blocking save of the snapshot through ``manager``; returns its
        wall seconds."""
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
            self.step, extra=extra, blocking=True,
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
    """

    cursor: int
    name: str
    threshold: Optional[int]
    part_g: Optional[Graph]
    part_local_ids: Optional[np.ndarray]
    part_ext: Optional[np.ndarray]
    dstats: DivideStats
    extract_time_s: float
    bg: Optional[BucketedGraph] = None
    bucketize_time_s: float = 0.0

    @property
    def is_rest(self) -> bool:
        return self.threshold is None

    @property
    def is_empty(self) -> bool:
        return self.part_g is None


class _PartPipeline:
    """The sequential scheduler behind :func:`dc_kcore`: divide, conquer,
    merge, shrink and checkpoint, one part at a time."""

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
        self.parts: List[PartReport] = state.reports
        self.preprocess_time_s = 0.0

    # ---------------- divide stage ---------------- #
    def _fresh_stats(self) -> DivideStats:
        return DivideStats(chunk_slots=_resolve_chunk_slots(self.divide_chunk))

    def _plan_on(self, graph: Graph, ext: np.ndarray, cursor: int) -> Optional[PartPlan]:
        """Divide: plan the part at ``cursor`` on ``graph``/``ext``."""
        if cursor < len(self.thresholds):
            t = self.thresholds[cursor]
            dstats = self._fresh_stats()
            cand_mask, extract_time = timed_candidates(
                graph, ext, t, self.strategy,
                chunk_slots=self.divide_chunk, stats=dstats,
            )
            if not cand_mask.any():
                return PartPlan(
                    cursor=cursor, name=f"core>={t}", threshold=t,
                    part_g=None, part_local_ids=None, part_ext=None,
                    dstats=dstats,
                    extract_time_s=extract_time,
                )
            t0 = time.perf_counter()
            part_g, part_local_ids = induced_subgraph(
                graph, cand_mask, chunk_slots=self.divide_chunk, stats=dstats
            )
            part_ext = ext[cand_mask]
            extract_time += time.perf_counter() - t0
            return PartPlan(
                cursor=cursor, name=f"core>={t}", threshold=t,
                part_g=part_g, part_local_ids=part_local_ids,
                part_ext=part_ext, dstats=dstats,
                extract_time_s=extract_time,
            )
        # Final (bottom) part: everything left.
        if graph.n_nodes == 0:
            return None
        return PartPlan(
            cursor=cursor, name="rest", threshold=None,
            part_g=graph, part_local_ids=None, part_ext=ext,
            dstats=self._fresh_stats(),
            extract_time_s=0.0,
        )

    def _build_plan(self, cursor: int) -> Optional[PartPlan]:
        """Divide on the CURRENT remaining graph."""
        return self._plan_on(
            self.remaining_graph, self.state.ext_remaining, cursor
        )

    def _bucketize(self, plan: PartPlan) -> None:
        """Reorder + bucketize the part -- the device-layout half of the
        divide stage."""
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

    # ---------------- conquer stage ---------------- #
    def _conquer(self, plan: PartPlan):
        """Conquer one part; returns ``(result, bitmap density, start
        sweep)``. A pending sweep snapshot that belongs to this part warm
        restarts it; with ``sweep_checkpoint_every`` the engine's
        ``on_sweep`` hook saves a snapshot every that many sweeps."""
        state = self.state
        t0 = time.perf_counter()
        init = None
        start_sweep = 0
        if self.pending_snap is not None:
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
        if self.sweep_checkpoint_every is not None:
            every = max(1, int(self.sweep_checkpoint_every))
            last = {"c": None if init is None else np.asarray(init)}

            def hook(it, coreness):
                if it % every:
                    return
                # The engine's view is a tensor on its device.
                c = coreness.cpu().numpy().astype(np.int32, copy=False)
                if last["c"] is not None and np.array_equal(last["c"], c):
                    return  # fixed point (or no progress): nothing to save
                save_s = SweepSnapshot(
                    coreness=c, parts_done=plan.cursor, sweep=start_sweep + it,
                    n_part=plan.part_g.n_nodes, threshold=plan.threshold,
                    thresholds=state.thresholds, fingerprint=state.fingerprint,
                ).save(self.sweeps_mgr)
                last["c"] = c
                if self.on_sweep_saved is not None:
                    self.on_sweep_saved(plan.cursor, start_sweep + it, save_s)

        self.preprocess_time_s += (
            (time.perf_counter() - t0) + plan.bucketize_time_s + plan.extract_time_s
        )
        if init is not None or hook is not None:
            res = self.decompose_fn(plan.bg, init_coreness=init, on_sweep=hook)
        else:
            res = self.decompose_fn(plan.bg)
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
        )

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
                report: PartReport) -> None:
        """Fold the part's ACTUALLY finalized nodes out of the remaining
        graph: E(v) of the kept nodes grows by their finalized neighbors."""
        state = self.state
        t0 = time.perf_counter()
        newly_mask_local = np.zeros(self.remaining_graph.n_nodes, dtype=bool)
        newly_mask_local[plan.part_local_ids[final_local]] = True
        keep_local = ~newly_mask_local
        ext_delta = external_info(
            self.remaining_graph, keep_local, newly_mask_local,
            chunk_slots=self.divide_chunk, stats=plan.dstats,
        )
        new_graph, keep_ids = induced_subgraph(
            self.remaining_graph, keep_local,
            chunk_slots=self.divide_chunk, stats=plan.dstats,
        )
        state.ext_remaining = state.ext_remaining[keep_local] + ext_delta
        state.remaining_ids = state.remaining_ids[keep_ids]
        self.remaining_graph = new_graph
        self.preprocess_time_s += time.perf_counter() - t0
        report.divide_transient_bytes = plan.dstats.peak_transient_bytes

    def _merge_rest(self, plan: PartPlan, res, density: float,
                    start_sweep: int) -> None:
        state = self.state
        state.coreness[state.remaining_ids] = res.coreness
        state.finalized[state.remaining_ids] = True
        report = self._report_for(plan, res, density, start_sweep,
                                  plan.part_g.n_nodes)
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
            on_done = None
            if report is not None:
                def on_done(_step, secs, _r=report):
                    _r.save_wall_s = secs
            blocked = self.state.save(self.state_mgr, on_done=on_done)
            self._purge_sweeps()
            if report is not None:
                report.save_time_s = blocked
        if self.on_part_done is not None and report is not None:
            self.on_part_done(len(self.parts) - 1, report)

    # ---------------- scheduler ---------------- #
    def run(self) -> None:
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
            res, density, start_sweep = self._conquer(plan)
            if plan.is_rest:
                self._merge_rest(plan, res, density, start_sweep)
                plan = None
                continue
            report, final_local = self._finalize_threshold(
                plan, res, density, start_sweep)
            self._shrink(plan, final_local, report)
            state.parts_done = plan.cursor + 1
            self._checkpoint_boundary(report)
            plan = self._build_plan(plan.cursor + 1)
        if not state.complete:
            # The shrink emptied the graph before the rest part.
            state.complete = True
            self._checkpoint_boundary(None)


_LATER_SLICE = {
    "overlap": "the overlapped prefetch pipeline (ROADMAP.md, queue 1, item 3)",
    "part_parallel": "part-parallel conquer (ROADMAP.md, queue 1, item 7)",
    "part_parallel_plan": "part-parallel conquer (ROADMAP.md, queue 1, item 7)",
    "slice_capacity_bytes": "part-parallel conquer (ROADMAP.md, queue 1, item 7)",
    "slice_timeout_s": "fault-tolerant conquer (ROADMAP.md, queue 1, item 7)",
    "max_retries": "fault-tolerant conquer (ROADMAP.md, queue 1, item 7)",
    "fault_plan": "fault-tolerant conquer (ROADMAP.md, queue 1, item 7)",
}


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
    fault_plan=None,
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

    ``overlap``, ``part_parallel`` (with its plan and slice capacity),
    ``slice_timeout_s``, ``max_retries`` and ``fault_plan`` belong to later
    slices of the port and raise :class:`NotImplementedError`.
    """
    later = {
        "overlap": overlap,
        "part_parallel": part_parallel, "part_parallel_plan": part_parallel_plan,
        "slice_capacity_bytes": slice_capacity_bytes,
        "slice_timeout_s": slice_timeout_s, "max_retries": max_retries,
        "fault_plan": fault_plan,
    }
    for name, value in later.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"dc_kcore({name}=...) is not ported yet: it comes with "
                f"{_LATER_SLICE[name]}"
            )
    if ckpt_retain < 1:
        raise ValueError(f"ckpt_retain must be >= 1, got {ckpt_retain}")
    if decompose_fn is None:
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
                quarantined_steps=len(restore_events),
                fault_events=list(restore_events),
            )
            return state.coreness.copy(), report
        # Rebuild the remaining graph from the original + finalized mask
        # (induced-subgraph composition is byte-stable).
        remaining_graph, keep_ids = induced_subgraph(
            g, ~state.finalized, chunk_slots=divide_chunk
        )
        if not np.array_equal(keep_ids, state.remaining_ids):
            raise ValueError("checkpoint remaining-id map inconsistent with "
                             "its finalized mask")

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
    )
    pipeline.run()

    report = DCKCoreReport(
        parts=pipeline.parts,
        total_time_s=time.perf_counter() - t_start,
        preprocess_time_s=pipeline.preprocess_time_s,
        resumed_parts=resumed_parts,
        quarantined_steps=len(restore_events),
        fault_events=list(restore_events),
    )
    if not bool((state.coreness >= 0).all()):
        raise MergeIncompleteError(
            f"merge left {int((state.coreness < 0).sum())} of {n} nodes "
            f"unfinalized -- every node must be resolved by exactly one part"
        )
    return state.coreness, report
