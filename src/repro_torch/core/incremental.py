"""Incremental coreness maintenance under edge churn.

``apply_updates(graph, coreness, edits)`` applies one batch of edge
inserts/deletes and returns the new graph plus its EXACT coreness, bit-
identical to a from-scratch :func:`~repro_torch.core.decompose.decompose` on the
post-edit graph — but touching only a bounded *dirty region* around the
edits, per the h-index locality result of Montresor et al.

Soundness design (the invariants the differential suite pins):

**Estimate seed.** The h-index fixed point converges to the true coreness
from ANY per-node upper bound ``est`` with ``core_new <= est <= deg_new +
ext``. With ``b_ins`` effective undirected inserts, no coreness rises by
more than ``b_ins``; deletes never raise coreness. So

    ``est = min(old_core + b_ins·[rise-region], deg_new)``

is a valid upper bound (``min`` with the new degree also covers brand-new
nodes and rows that lost edges).

**Dirty region (initial frontier).** Restricting the first sweep to a seed
set ``D`` is exact iff every node whose estimate must MOVE during the
iteration either lies in ``D`` or is reached by the dirty-bit frontier
from a node that changed. Two hazards force explicit BFS regions:

- *Rise region* (inserts): coreness can only rise along a path from an
  insert endpoint where each hop's old coreness stays within ``b_ins - 1``
  of the previous hop's (with ``b_ins = 1`` this is the classic equal-
  coreness subcore). Nodes outside cannot rise, by a cause-chain argument:
  the first riser outside the band would need a neighbor risen further.
- *Fall region* (deletes): a node's estimate can start AT its final value
  yet its neighbors still need re-evaluation (delete one edge of a
  triangle: both endpoints drop to est=1 at seed time — no sweep-time
  change event — while the third corner must fall from 2 to 1 "on its
  own"). So every node that might fall must be in ``D`` itself: BFS from
  delete endpoints, expanding x→y iff ``old(y) ∈ [old(x) - b_del + 1,
  old(x)]``.

Any node not in either region keeps ``est = old_core`` exactly and is
provably already at its fixed point; the terminal-state argument (no
change ⇒ every swept row satisfies ``c = H(c)``, plus the regions cover
all movers) gives bit-identity.

**Fallback.** When the dirty region exceeds ``dirty_budget_frac`` of the
graph the locality win is gone — ``apply_updates`` falls back to a full
from-scratch decompose (same bit-exact result, mode ``"full"`` in the
report). Esfandiari-style sketching is the lossy alternative; this engine
keeps the exactness contract and pays the full sweep instead.

This is the port of the JAX package's ``repro.core.incremental``: the
splice and the region BFS are the same numpy, and the re-sweep runs
:func:`~repro_torch.core.decompose.decompose` on ``device`` (default
``"cuda"``, through the fused or h-index CUDA kernel with ``op="fused"`` /
``"kernel"``). Each result also carries the host and device seconds of its
stages (``stage_s``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core.decompose import DecomposeResult, decompose
from repro_torch.device import resolve_device
from repro_torch.graph.build import bucketize
from repro_torch.graph.delta import DeltaResult, EdgeEdits, apply_edge_deltas
from repro_torch.graph.structs import Graph


@dataclasses.dataclass(frozen=True)
class UpdateResult:
    """Outcome of one incremental update batch.

    ``mode`` is ``"incremental"`` (seed-restricted re-sweep), ``"full"``
    (dirty region blew the budget — from-scratch decompose), or ``"noop"``
    (the batch had no effective edits). ``dirty_mask`` is the original-id
    boolean seed region (all-True under ``"full"``, for uniformity);
    ``gathered_rows`` is the total row count actually swept — the number
    the dirty-region-bound tests compare against a full run's.
    ``stage_s`` splits ``wall_time_s`` into its stages: ``"splice"`` (the
    CSR delta), ``"region"`` (the dirty-region BFS), ``"bucketize"`` and
    ``"resweep"`` (the decompose, device time included).
    """

    graph: Graph
    coreness: np.ndarray
    mode: str
    delta: DeltaResult
    dirty_mask: np.ndarray
    dirty_count: int
    dirty_frac: float
    gathered_rows: int
    decompose_result: Optional[DecomposeResult]
    wall_time_s: float
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def n_inserted(self) -> int:
        return self.delta.n_inserted

    @property
    def n_deleted(self) -> int:
        return self.delta.n_deleted


def _band_flood(
    g: Graph,
    seed_mask: np.ndarray,
    old: np.ndarray,
    lo_off: int,
    hi_off: int,
) -> np.ndarray:
    """Band-constrained BFS over ``g``: grow ``seed_mask`` by repeatedly
    adding any neighbor ``y`` of a frontier node ``x`` with
    ``old[y] ∈ [old[x] + lo_off, old[x] + hi_off]``. Returns the closure
    as a boolean mask (seeds included). Vectorized frontier flood: each
    round gathers the frontier rows' CSR slices in one shot.
    """
    region = seed_mask.copy()
    frontier = np.nonzero(seed_mask)[0]
    indptr, indices = g.indptr, g.indices
    while frontier.size:
        counts = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
        keep = counts > 0
        rows, counts = frontier[keep], counts[keep]
        if rows.size == 0:
            break
        # Concatenated slot indices of the frontier rows (cumsum trick).
        total = int(counts.sum())
        step = np.ones(total, dtype=np.int64)
        starts = indptr[rows].astype(np.int64)
        ends = np.cumsum(counts)
        step[0] = starts[0]
        step[ends[:-1]] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
        slots = np.cumsum(step)
        neigh = indices[slots].astype(np.int64)
        src_old = np.repeat(old[rows], counts)
        ok = (
            (old[neigh] >= src_old + lo_off)
            & (old[neigh] <= src_old + hi_off)
            & ~region[neigh]
        )
        nxt = np.unique(neigh[ok])
        region[nxt] = True
        frontier = nxt
    return region


def apply_updates(
    g: Graph,
    coreness: np.ndarray,
    edits: EdgeEdits,
    *,
    dirty_budget_frac: float = 0.5,
    op: str = "count",
    max_bucket_rows="auto",
    n_nodes: Optional[int] = None,
    device="cuda",
) -> UpdateResult:
    """Apply one edit batch and maintain exact coreness.

    ``coreness`` must be the exact coreness of ``g`` (original-id order) —
    the previous batch's output, or a from-scratch decompose / oracle run.
    ``dirty_budget_frac`` caps the seed region; past it the engine falls
    back to a full re-sweep (set to ``0.0`` to force the fallback, ``1.0``
    to never take it). ``op``/``max_bucket_rows`` pass through to the
    engine, so the incremental path exercises the same sweep kernels as
    batch runs. ``device`` is where the re-sweep runs (default ``"cuda"``;
    without a GPU that raises -- pass ``"cpu"`` for the plain versions).
    """
    t0 = time.perf_counter()
    device = resolve_device(device)  # fail fast, noop batches included
    stage_s: Dict[str, float] = {}
    old = np.asarray(coreness, dtype=np.int64)
    if old.shape != (g.n_nodes,):
        raise ValueError(
            f"coreness shape {old.shape} != ({g.n_nodes},)"
        )
    delta = apply_edge_deltas(g, edits, n_nodes=n_nodes)
    stage_s["splice"] = time.perf_counter() - t0
    g_new = delta.graph
    n_new = g_new.n_nodes
    if n_new > old.size:  # new trailing nodes enter with old coreness 0
        old = np.concatenate(
            [old, np.zeros(n_new - old.size, dtype=np.int64)]
        )

    if delta.n_effective == 0:
        return UpdateResult(
            graph=g_new, coreness=old.astype(np.int32, copy=False),
            mode="noop", delta=delta,
            dirty_mask=np.zeros(n_new, dtype=bool), dirty_count=0,
            dirty_frac=0.0, gathered_rows=0, decompose_result=None,
            wall_time_s=time.perf_counter() - t0, stage_s=stage_s,
        )

    t_region = time.perf_counter()
    b_ins, b_del = delta.n_inserted, delta.n_deleted
    single = delta.n_effective == 1
    rise = np.zeros(n_new, dtype=bool)
    if b_ins:
        if single:
            # Classic single-insert theorem: only nodes with old core ==
            # K = min(old(u), old(v)) in the K-subcore of the root can
            # rise (by exactly 1). The higher endpoint cannot move.
            k = min(old[delta.ins_u[0]], old[delta.ins_v[0]])
            for e in (delta.ins_u[0], delta.ins_v[0]):
                if old[e] == k:
                    rise[e] = True
        else:
            rise[delta.ins_u] = True
            rise[delta.ins_v] = True
        # Coreness rises only along paths where each hop's old value is
        # within [old(x), old(x) + b_ins - 1] of the previous hop's.
        rise = _band_flood(g_new, rise, old, 0, b_ins - 1)
    fall = np.zeros(n_new, dtype=bool)
    if b_del:
        seeds = np.zeros(n_new, dtype=bool)
        if single:
            # Dual single-delete theorem: only the K-subcore of the
            # endpoints can fall. Both endpoints of the deleted edge are
            # seeded, so old-graph subcore paths crossing it stay covered.
            k = min(old[delta.del_u[0]], old[delta.del_v[0]])
            for e in (delta.del_u[0], delta.del_v[0]):
                if old[e] == k:
                    seeds[e] = True
        else:
            seeds[delta.del_u] = True
            seeds[delta.del_v] = True
        # Fallers may never emit a change event (triangle case: both
        # delete endpoints seed at their final value), so the whole
        # potential-fall closure must be in the initial frontier.
        fall = _band_flood(g_new, seeds, old, -(b_del - 1), 0)
    dirty = rise | fall
    dirty_count = int(dirty.sum())
    dirty_frac = dirty_count / max(1, n_new)

    deg_new = g_new.degrees.astype(np.int64)
    stage_s["region"] = time.perf_counter() - t_region
    if dirty_frac > dirty_budget_frac:
        # Locality win is gone — full from-scratch sweep (same bits).
        t_b = time.perf_counter()
        bg = bucketize(g_new, max_bucket_rows=max_bucket_rows)
        stage_s["bucketize"] = time.perf_counter() - t_b
        res = decompose(bg, op=op, device=device)
        stage_s["resweep"] = res.wall_time_s
        return UpdateResult(
            graph=g_new, coreness=res.coreness, mode="full", delta=delta,
            dirty_mask=np.ones(n_new, dtype=bool), dirty_count=dirty_count,
            dirty_frac=dirty_frac,
            gathered_rows=int(sum(res.active_rows_per_iter)),
            decompose_result=res, wall_time_s=time.perf_counter() - t0,
            stage_s=stage_s,
        )

    est = np.minimum(np.where(rise, old + b_ins, old), deg_new)
    t_b = time.perf_counter()
    bg = bucketize(g_new, max_bucket_rows=max_bucket_rows)
    stage_s["bucketize"] = time.perf_counter() - t_b
    res = decompose(
        bg, op=op,
        init_coreness=est.astype(np.int32),
        seed_nodes=dirty,
        device=device,
    )
    stage_s["resweep"] = res.wall_time_s
    return UpdateResult(
        graph=g_new, coreness=res.coreness, mode="incremental", delta=delta,
        dirty_mask=dirty, dirty_count=dirty_count, dirty_frac=dirty_frac,
        gathered_rows=int(sum(res.active_rows_per_iter)),
        decompose_result=res, wall_time_s=time.perf_counter() - t0,
        stage_s=stage_s,
    )
