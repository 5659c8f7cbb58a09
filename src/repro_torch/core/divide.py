"""The Divide step — Exact-Divide and Rough-Divide (paper Section 4.2).

Both strategies select, on the *remaining* graph (original graph minus all
already-finalized upper parts), a candidate node set whose decomposition
will finalize every node with coreness >= the threshold ``t``:

* **Exact-Divide** extracts the exact generalized t-core: iteratively peel
  nodes with ``deg(v) + ext(v) < t``. Expensive (paper Fig 9) but every node
  of the extracted part finalizes.
* **Rough-Divide** takes the one-shot degree filter
  ``{v : deg(v) + ext(v) >= t}`` — a superset of the t-core that is
  3.7-14.3x cheaper to extract in the paper. Nodes that decompose to a value
  < t are *not* final and fall through to the next part.

``ext`` here generalizes the paper's Definition 3 to the multi-part setting:
it counts neighbors in the union of all finalized upper parts, whose
coreness is >= every threshold still to be processed — so they behave as
infinite-coreness virtual neighbors for the remainder (Corollary 1 analog).

Also provides :func:`plan_thresholds`, the resource-driven threshold picker:
given a per-part memory budget, choose division thresholds from the degree
distribution so every part's device footprint fits — this automates the
paper's "limited resources" knob.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.graph.build import (
    DivideStats, _count_pass, _resolve_chunk_slots, iter_row_ranges,
)
from repro_torch.graph.structs import Graph
from repro_torch.trace import spanned


def rough_candidates(deg: np.ndarray, ext: np.ndarray, t: int) -> np.ndarray:
    """Rough-Divide candidate mask on the remaining graph.

    Pure ``O(n)`` arithmetic over the degree and ext arrays — no edge-sized
    scratch; on the streaming ingest path it runs before (or without) the
    CSR via :func:`rough_candidates_from_store`.
    """
    return (deg.astype(np.int64) + ext.astype(np.int64)) >= t


def rough_candidates_from_store(store, n_nodes: int, ext: np.ndarray, t: int) -> np.ndarray:
    """Rough-Divide directly over a spilled :class:`~repro_torch.graph.io.EdgeStore`.

    Uses the store's duplicate-inclusive degree counts, so the mask is a
    superset of :func:`rough_candidates` on the deduplicated CSR (equal when
    the stream carries no duplicate edges) — still a valid Rough-Divide
    candidate set (supersets only defer non-final nodes to the next part).
    Together with :func:`~repro_torch.graph.io.induced_subgraph_from_store` this
    lets the first part of a streamed pipeline be planned *and* extracted
    without the full CSR ever resident.
    """
    return rough_candidates(store.dup_degrees(int(n_nodes)), ext, t)


@spanned("repro_torch.divide.exact")
def exact_candidates(
    g: Graph,
    ext: np.ndarray,
    t: int,
    chunk_slots: Optional[int] = None,
    stats: Optional[DivideStats] = None,
    device=None,
) -> np.ndarray:
    """Exact-Divide: generalized t-core mask via peeling with ext credit.

    Each peel round gathers only the *frontier* rows' adjacency, in chunks
    of at most ``chunk_slots`` slots (``None`` =
    :data:`~repro_torch.graph.build.DEFAULT_DIVIDE_CHUNK_SLOTS`) — the transient
    is bounded by the chunk budget plus ``O(n)`` state, where the previous
    implementation pinned an edge-sized ``np.repeat`` source vector for the
    whole peel. The peeled set is identical at every chunk size (each round
    decrements alive neighbors of the full frontier, chunked or not).
    With ``device`` (a torch device) the rounds run there, each in one
    piece (:func:`_exact_candidates_on`), to the same mask.
    """
    if device is not None:
        return _exact_candidates_on(g, ext, t, device, stats)
    n = g.n_nodes
    budget = _resolve_chunk_slots(chunk_slots)
    alive = np.ones(n, dtype=bool)
    deg = g.degrees.astype(np.int64) + ext.astype(np.int64)
    row_len = np.diff(g.indptr).astype(np.int64)
    persistent = alive.nbytes + deg.nbytes + row_len.nbytes
    frontier = np.nonzero(alive & (deg < t))[0]
    while frontier.size:
        alive[frontier] = False
        dec = np.zeros(n, dtype=np.int64)
        lens = row_len[frontier]
        round_live = 0
        # cum is an indptr over the frontier rows, so the same row-range
        # chunker that drives induced_subgraph/external_info groups them.
        cum = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])
        for start, stop in iter_row_ranges(cum, budget):
            rows = frontier[start:stop]
            group = lens[start:stop]
            total = int(cum[stop] - cum[start])
            if total == 0:
                continue
            # Vectorized multi-slice gather of the group's adjacency.
            idx = (
                np.arange(total, dtype=np.int64)
                - np.repeat(cum[start:stop] - cum[start], group)
                + np.repeat(g.indptr[rows], group)
            )
            cols = g.indices[idx]
            live = alive[cols]
            dec += np.bincount(cols[live], minlength=n)
            round_live += int(live.sum())
            if stats is not None:
                stats.n_chunks += 1
                stats.input_slots += total
                stats.kept_slots += int(live.sum())
                stats.bump(
                    persistent + dec.nbytes + frontier.nbytes + lens.nbytes
                    + idx.nbytes * 2 + cols.nbytes + live.nbytes
                )
        if stats is not None:
            # Dense model of one peel round: the pinned np.repeat source
            # vector plus three edge masks over ALL slots (regardless of
            # frontier size) and the int32 compaction of this round's hits.
            stats.note_pass(2 * g.n_edges, round_live, slot_bytes=11, kept_bytes=4)
        deg -= dec
        frontier = np.nonzero(alive & (deg < t) & (dec > 0))[0]
    return alive


def _exact_candidates_on(g: Graph, ext: np.ndarray, t: int, device,
                         stats: Optional[DivideStats]) -> np.ndarray:
    """:func:`exact_candidates` as torch ops on ``device``: the same rounds,
    each gathering the whole frontier's adjacency at once."""
    n = g.n_nodes
    indptr = torch.from_numpy(np.ascontiguousarray(g.indptr, dtype=np.int64)).to(device)
    cols = torch.from_numpy(np.ascontiguousarray(g.indices)).to(device)
    row_len = indptr[1:] - indptr[:-1]
    deg = row_len + torch.from_numpy(np.asarray(ext, dtype=np.int64)).to(device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    frontier = torch.nonzero(deg < t).flatten()
    while frontier.numel():
        alive[frontier] = False
        lens = row_len[frontier]
        total = int(lens.sum())
        # Each frontier row's slots, then its neighbours still alive.
        first = indptr[frontier] - (torch.cumsum(lens, 0) - lens)
        slots = (torch.repeat_interleave(first, lens, output_size=total)
                 + torch.arange(total, device=device))
        live = cols[slots].long()
        live = live[alive[live]]
        dec = torch.bincount(live, minlength=n)
        _count_pass(stats, total, live.numel())
        deg -= dec
        frontier = torch.nonzero(alive & (deg < t) & (dec > 0)).flatten()
    return alive.cpu().numpy()


def timed_candidates(
    g: Graph,
    ext: np.ndarray,
    t: int,
    strategy: str,
    chunk_slots: Optional[int] = None,
    stats: Optional[DivideStats] = None,
    device=None,
) -> Tuple[np.ndarray, float]:
    """Candidate mask plus extraction wall time (paper Fig 9 measurement);
    ``device`` runs Exact-Divide's peel there."""
    t0 = time.perf_counter()
    if strategy == "rough":
        mask = rough_candidates(g.degrees, ext, t)
    elif strategy == "exact":
        mask = exact_candidates(g, ext, t, chunk_slots=chunk_slots, stats=stats,
                                device=device)
    else:
        raise ValueError(f"unknown divide strategy: {strategy}")
    return mask, time.perf_counter() - t0


def plan_thresholds(
    g: Union[Graph, np.ndarray],
    part_budget_bytes: int,
    max_parts: int = 8,
    bytes_per_edge: int = 8,
) -> List[int]:
    """Pick division thresholds so each part's footprint fits the budget.

    ``g`` may be a :class:`Graph` or just its **degree array** — planning
    needs nothing else, so on the streaming ingest path it can run from
    :meth:`EdgeStore.dup_degrees <repro_torch.graph.io.EdgeStore.dup_degrees>`
    before (or without) the edge list being resident.

    Walks the degree distribution from the top as runs of equal degree
    (nodes of one degree value are indivisible by thresholds): the current
    part greedily absorbs runs while its padded edge estimate fits the
    budget; the first run that would overflow closes the part, whose
    threshold is the degree of its last absorbed run (part = ``deg >= t``).
    A repeated overflow at the same degree value — the old early-``break``
    bug — cannot occur: runs are strictly decreasing, so every emitted
    threshold is strictly below the previous one. Returns descending
    thresholds (possibly empty = no division needed).

    Every planned part's estimate fits the budget, with one unavoidable
    exception: a single run that alone exceeds it (equal-degree nodes
    cannot be split by a degree threshold) becomes its own over-budget
    part. The trailing run group is always closed with its own threshold:
    division was needed (total > budget), so the planned remainder must
    not merge with the unsplittable low-degree tail into an over-budget
    rest part. Thresholds <= 1 are never emitted — the implicit final
    "rest" covers the deg <= 1 tail.
    """
    deg_src = g.degrees if isinstance(g, Graph) else np.asarray(g)
    deg = np.sort(deg_src.astype(np.int64))[::-1]
    if deg.size == 0:
        return []
    total = int(deg.sum()) * bytes_per_edge
    if total <= part_budget_bytes:
        return []
    # Runs of equal degree, descending: values[i] with total bytes run_bytes[i].
    values, run_len = np.unique(deg, return_counts=True)
    values, run_len = values[::-1], run_len[::-1]
    run_bytes = values * run_len * bytes_per_edge
    thresholds: List[int] = []
    acc = 0
    prev_v = None
    for v, rb in zip(values, run_bytes):
        if v <= 1:
            break
        if acc > 0 and acc + int(rb) > part_budget_bytes:
            # Close the current part before this run; its threshold is the
            # last absorbed run's degree (strictly greater than v).
            thresholds.append(int(prev_v))
            acc = 0
            if len(thresholds) >= max_parts - 1:
                break
        acc += int(rb)
        prev_v = v
    # Close the trailing group too: reaching the loop means total > budget,
    # so without this cut the planned remainder would merge with the
    # deg <= 1 tail into an over-budget rest and the graph could even end
    # up monolithic (the old planner's under-division modes).
    if (acc > 0 and prev_v is not None and prev_v > 1
            and len(thresholds) < max_parts - 1
            and (not thresholds or prev_v < thresholds[-1])):
        thresholds.append(int(prev_v))
    return thresholds
