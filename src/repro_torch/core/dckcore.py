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

This is the port of the JAX package's ``repro.core.dckcore`` on its
sequential path; the per-part reports are field-for-field the same.
Checkpoints and resume, sweep snapshots, the overlapped prefetch pipeline,
part-parallel waves and the fault-tolerance layer are later slices of the
port (``ROADMAP.md``, "Modules to port"); their options raise
:class:`NotImplementedError` here.
"""
from __future__ import annotations

import dataclasses
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
    # Checkpoint save seconds (blocked / completed); 0 until checkpoints
    # are ported.
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
    """Host state of a DC-kCore run at a part boundary.

    ``parts_done`` is the cursor: how many thresholds of the (descending,
    deduplicated) plan have been consumed. ``complete`` marks that the
    final "rest" part also finished.
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


# Conquer-engine adapter: ``fn(bg) -> DecomposeResult``.
DecomposeFn = Callable[..., DecomposeResult]
PartHook = Callable[[int, PartReport], None]


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
    merge and shrink, one part at a time."""

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
        """Conquer one part; returns ``(result, bitmap density)``."""
        self.preprocess_time_s += plan.bucketize_time_s + plan.extract_time_s
        res = self.decompose_fn(plan.bg)
        return res, bitmap_density(plan.bg)

    # ---------------- merge + shrink ---------------- #
    def _report_for(self, plan: PartPlan, res, density: float,
                    finalized: int) -> PartReport:
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
        )

    def _finalize_threshold(self, plan: PartPlan, res, density: float):
        """Merge a threshold part's result into the global state and
        append its report (before the shrink)."""
        state = self.state
        # Finalize nodes that resolved at >= t (all of them for Exact-Divide).
        final_local = res.coreness >= plan.threshold
        part_orig_ids = state.remaining_ids[plan.part_local_ids]
        newly = part_orig_ids[final_local]
        state.coreness[newly] = res.coreness[final_local]
        state.finalized[newly] = True
        report = self._report_for(plan, res, density, int(final_local.sum()))
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

    def _merge_rest(self, plan: PartPlan, res, density: float) -> None:
        state = self.state
        state.coreness[state.remaining_ids] = res.coreness
        state.finalized[state.remaining_ids] = True
        report = self._report_for(plan, res, density, plan.part_g.n_nodes)
        self.parts.append(report)
        state.remaining_ids = np.zeros(0, dtype=np.int64)
        state.ext_remaining = np.zeros(0, dtype=np.int32)
        state.complete = True
        self._part_boundary(report)

    def _part_boundary(self, report: PartReport) -> None:
        if self.on_part_done is not None:
            self.on_part_done(len(self.parts) - 1, report)

    # ---------------- scheduler ---------------- #
    def run(self) -> None:
        state = self.state
        plan = self._build_plan(state.parts_done)
        while plan is not None:
            if plan.is_empty:
                # No candidates at this threshold: consume the cursor.
                state.parts_done = plan.cursor + 1
                plan = self._build_plan(plan.cursor + 1)
                continue
            self._bucketize(plan)
            res, density = self._conquer(plan)
            if plan.is_rest:
                self._merge_rest(plan, res, density)
                plan = None
                continue
            report, final_local = self._finalize_threshold(plan, res, density)
            self._shrink(plan, final_local, report)
            state.parts_done = plan.cursor + 1
            self._part_boundary(report)
            plan = self._build_plan(plan.cursor + 1)
        # A shrink that empties the graph before the rest part ends the run.
        state.complete = True


_LATER_SLICE = {
    "checkpoint_dir": "checkpoints and resume (ROADMAP.md, queue 1, item 3)",
    "resume": "checkpoints and resume (ROADMAP.md, queue 1, item 3)",
    "sweep_checkpoint_every": "sweep snapshots (ROADMAP.md, queue 1, item 3)",
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
    ``decompose_fn`` is not given: a custom engine (``fn(bg)``) owns its
    own configuration, so combining them raises.

    ``reorder`` (``"identity"`` / ``"bfs"`` / ``"rcm"``) applies a
    locality-aware node ordering to *each part* before bucketizing it;
    ``reorder_sample_edges`` computes it from a bounded edge sample.
    ``max_bucket_rows`` is forwarded to
    :func:`~repro_torch.graph.build.bucketize` (``"auto"`` = the
    degree-profile tile autotuner). ``divide_chunk`` bounds the divide
    step's transient host bytes (``None`` = the built-in budget).
    ``on_part_done`` (``hook(part_index, report)``) fires after each part.

    ``checkpoint_dir``, ``resume``, ``sweep_checkpoint_every``, ``overlap``,
    ``part_parallel`` (with its plan and slice capacity),
    ``slice_timeout_s``, ``max_retries`` and ``fault_plan`` belong to
    later slices of the port and raise :class:`NotImplementedError`.
    """
    later = {
        "checkpoint_dir": checkpoint_dir, "resume": resume,
        "sweep_checkpoint_every": sweep_checkpoint_every, "overlap": overlap,
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
    if decompose_fn is None:
        decompose_fn = (  # noqa: E731
            lambda bg: decompose(bg, op=engine, int16=int16, device=device)
        )
    elif engine != "sorted" or int16 or device != "cuda":
        raise ValueError("engine=/int16=/device= configure the built-in "
                         "engine; with decompose_fn they would be silently "
                         "ignored -- configure the custom engine instead")
    thresholds = sorted(set(int(t) for t in thresholds), reverse=True)
    t_start = time.perf_counter()

    n = g.n_nodes
    state = PipelineState.fresh(g, thresholds)
    pipeline = _PartPipeline(
        state=state,
        remaining_graph=g,
        thresholds=thresholds,
        strategy=strategy,
        decompose_fn=decompose_fn,
        row_align=row_align,
        reorder=reorder,
        max_bucket_rows=max_bucket_rows,
        reorder_sample_edges=reorder_sample_edges,
        divide_chunk=divide_chunk,
        on_part_done=on_part_done,
    )
    pipeline.run()

    report = DCKCoreReport(
        parts=pipeline.parts,
        total_time_s=time.perf_counter() - t_start,
        preprocess_time_s=pipeline.preprocess_time_s,
    )
    if not bool((state.coreness >= 0).all()):
        raise MergeIncompleteError(
            f"merge left {int((state.coreness < 0).sum())} of {n} nodes "
            f"unfinalized -- every node must be resolved by exactly one part"
        )
    return state.coreness, report
