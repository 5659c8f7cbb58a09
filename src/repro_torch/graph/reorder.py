"""Locality-aware node reordering: BFS and reverse Cuthill–McKee.

Node ids in real (and synthetic power-law) graphs are arbitrary, so the
neighbors of a degree-bucket row-tile are scattered across the whole id
range and the bucket-adjacency bitmap recorded at bucketize time is
near-dense: the static frontier filter almost never fires and the row-exact
dirty bits do all the skipping. Both the paper's
divide-and-conquer strategy (arXiv 2112.14840) and Montresor et al.'s
distributed k-core argument (arXiv 1103.5320) lean on neighborhoods being
co-located; a one-shot reordering pass at build time makes that true for
our tiles:

* :func:`bfs_order` — level-synchronous breadth-first order from the
  highest-degree node of each component. Neighbors land in the same or the
  adjacent BFS level, so a contiguous run of ids spans few levels.
* :func:`rcm_order` — reverse Cuthill–McKee: Cuthill–McKee from a
  low-degree (pseudo-peripheral) start, children visited in
  (parent-rank, degree) order, whole order reversed. The classic
  bandwidth-minimizing order; neighbor ids cluster tightest here.

Both return a permutation ``perm`` with ``perm[new_id] = old_id`` (so
``inv_perm[old_id] = new_id`` is its argsort). :func:`reorder_graph`
applies one to a :class:`~repro_torch.graph.structs.Graph` and records
``perm``/``inv_perm`` on the result; ``bucketize`` propagates them onto the
:class:`~repro_torch.graph.structs.BucketedGraph` and the decompose engines
un-permute their coreness output transparently, so *every caller keeps
original-id semantics end to end* — reordering is purely a layout decision.

Degree-0 nodes are appended at the end of every order (they join no bucket
and their coreness is fixed at ``ext`` from the start).

:func:`bitmap_density` is the metric the pass optimizes: the fraction of
set bits in the bucket-adjacency bitmap, i.e. how often the static frontier
filter *cannot* rule out a tile. Lower is better; ``bench_kcore`` fig13
reports it ordered vs. unordered.

For paper-scale parts the full traversal's working set (frontier arrays +
the whole CSR) is itself a resource problem, so :func:`sampled_order`
computes the same BFS/RCM orders from a bounded **edge-sample skeleton**:
every positive-degree node keeps at least one (and at most
``edge_budget // n`` evenly-strided) neighbors, so the traversal touches
``O(max(n, edge_budget))`` slots instead of ``O(m)`` while still producing
a full, valid permutation. ``reorder_graph(..., sample_edges=...)``
plumbs it through; the trade is a denser bitmap than the exact order, by a
bounded factor on the power-law fixtures (pinned in tests).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.graph.structs import BucketedGraph, Graph

REORDER_METHODS = ("identity", "bfs", "rcm")


def _flat_neighbors(g: Graph, frontier: np.ndarray):
    """Concatenated adjacency of ``frontier`` plus the parent rank of each
    slot, without a Python loop over frontier nodes."""
    starts = g.indptr[frontier]
    lens = (g.indptr[frontier + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # Standard CSR flat-gather trick: per-slot index = slot rank + the gap
    # between each row's start and the running total of previous rows.
    shift = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    flat = g.indices[np.arange(total, dtype=np.int64) + shift].astype(np.int64)
    parent_rank = np.repeat(np.arange(frontier.size, dtype=np.int64), lens)
    return flat, parent_rank


def _level_order(g: Graph, *, degree_sorted_children: bool, start_low_degree: bool) -> np.ndarray:
    """Level-synchronous (Cuthill–McKee-style) traversal over all components.

    Returns the visitation order (``order[i] = old id``) of all nodes with
    degree > 0; isolated nodes are NOT included (callers append them).
    """
    n = g.n_nodes
    deg = g.degrees.astype(np.int64)
    visited = np.zeros(n, dtype=bool)
    out = np.empty(int((deg > 0).sum()), dtype=np.int64)
    pos = 0
    # Component seeds in degree order (ascending for CM, descending for BFS);
    # a single pointer sweep keeps seed selection O(n log n) total.
    seeds = np.argsort(deg if start_low_degree else -deg, kind="stable")
    seeds = seeds[deg[seeds] > 0]
    si = 0
    while pos < out.size:
        while si < seeds.size and visited[seeds[si]]:
            si += 1
        start = int(seeds[si])
        visited[start] = True
        out[pos] = start
        pos += 1
        frontier = np.array([start], dtype=np.int64)
        while frontier.size:
            flat, parent_rank = _flat_neighbors(g, frontier)
            fresh = ~visited[flat]
            cand, pr = flat[fresh], parent_rank[fresh]
            if cand.size == 0:
                break
            if degree_sorted_children:
                # Cuthill–McKee: children grouped by parent visitation rank,
                # lowest-degree first within each group.
                cand = cand[np.lexsort((deg[cand], pr))]
            # else: adjacency order within parent groups (flat gather already
            # emits slots grouped by parent rank) — plain BFS.
            # First-occurrence dedup that respects the order just established.
            _, first = np.unique(cand, return_index=True)
            level = cand[np.sort(first)]
            visited[level] = True
            out[pos : pos + level.size] = level
            pos += level.size
            frontier = level
    return out


def bfs_order(g: Graph) -> np.ndarray:
    """BFS visitation order (``perm[new_id] = old_id``), hubs first.

    Each component is traversed from its highest-degree node; degree-0 nodes
    are appended at the end in ascending id order.
    """
    core = _level_order(g, degree_sorted_children=False, start_low_degree=False)
    isolated = np.nonzero(g.degrees == 0)[0].astype(np.int64)
    return np.concatenate([core, isolated])


def rcm_order(g: Graph) -> np.ndarray:
    """Reverse Cuthill–McKee order (``perm[new_id] = old_id``).

    Cuthill–McKee from the lowest-degree node of each component with
    degree-sorted children, reversed; degree-0 nodes appended at the end
    (outside the reversal — they carry no adjacency to compress).
    """
    core = _level_order(g, degree_sorted_children=True, start_low_degree=True)
    isolated = np.nonzero(g.degrees == 0)[0].astype(np.int64)
    return np.concatenate([core[::-1], isolated])


def invert_order(perm: np.ndarray) -> np.ndarray:
    """``inv_perm`` with ``inv_perm[perm] == arange(n)``."""
    inv = np.empty(perm.size, dtype=np.int64)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return inv


def sample_edge_skeleton(g: Graph, edge_budget: int) -> Graph:
    """Bounded edge-sample skeleton of ``g`` for out-of-core ordering.

    Deterministic per-row strided sampling: every node of degree > 0 keeps
    ``min(deg, k)`` neighbors at evenly-spaced positions of its (sorted)
    adjacency row, with ``k = max(1, edge_budget // n_pos)``. Evenly-strided
    picks cover the row's id span, which is what the orders care about; the
    per-node floor of one neighbor guarantees no positive-degree node is
    isolated in the skeleton, so the skeleton traversal places *every* node.
    Sampled slots number ``<= max(n_pos, edge_budget)``.
    """
    deg = g.degrees.astype(np.int64)
    rows = np.nonzero(deg > 0)[0].astype(np.int64)
    if rows.size == 0:
        return Graph.empty(g.n_nodes)
    k = max(1, int(edge_budget) // rows.size)
    kv = np.minimum(deg[rows], k)
    total = int(kv.sum())
    row_rep = np.repeat(rows, kv)
    kv_rep = np.repeat(kv, kv)
    # j-th pick of each row: position floor(j * deg / kv) within the row.
    j = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(kv)[:-1]]), kv
    )
    pos = (j * deg[row_rep]) // kv_rep
    picked = g.indices[g.indptr[row_rep] + pos].astype(np.int64)
    return Graph.from_edges(row_rep, picked, n_nodes=g.n_nodes)


def sampled_order(g: Graph, method: str = "rcm", edge_budget: int = 1 << 20) -> np.ndarray:
    """BFS/RCM order computed from an edge sample under a slot budget.

    The ROADMAP out-of-core follow-up: the exact orders traverse the full
    CSR, which at paper scale does not fit next to the part being built.
    This computes the same traversal on the :func:`sample_edge_skeleton`
    (``O(max(n, edge_budget))`` slots) and returns a full valid permutation
    over all ``n`` nodes — nodes isolated in ``g`` are appended at the end
    exactly as in the exact orders.
    """
    if method not in ("bfs", "rcm"):
        raise ValueError(f"sampled order needs 'bfs' or 'rcm', got {method!r}")
    skel = sample_edge_skeleton(g, edge_budget)
    return bfs_order(skel) if method == "bfs" else rcm_order(skel)


def permute_graph(g: Graph, perm: np.ndarray) -> Graph:
    """Relabel ``g``'s CSR by ``perm`` (``perm[new_id] = old_id``),
    recording ``perm``/``inv_perm`` on the result."""
    inv = invert_order(perm)
    n = g.n_nodes
    # Relabel the symmetric CSR directly — a bijection needs no re-dedup.
    src = inv[np.repeat(np.arange(n, dtype=np.int64), g.degrees)]
    dst = inv[g.indices]
    order = np.lexsort((dst, src))
    counts = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Graph(
        indptr=indptr,
        indices=dst[order].astype(np.int32),
        n_nodes=n,
        perm=perm,
        inv_perm=inv,
    )


def reorder_graph(g: Graph, method: str = "rcm", sample_edges: Optional[int] = None) -> Graph:
    """Relabel ``g`` by a locality-aware order, recording the permutation.

    ``method`` is one of ``"identity"`` (returns ``g`` unchanged), ``"bfs"``
    or ``"rcm"``. The returned graph's CSR is in the new id space; its
    ``perm``/``inv_perm`` fields let downstream components translate back,
    which :func:`~repro_torch.graph.build.bucketize` and both decompose engines do
    automatically — callers keep original-id semantics throughout.

    ``sample_edges`` switches the *ordering computation* to the sampled
    variant (:func:`sampled_order`) under that slot budget — the traversal's
    working set stops scaling with ``m``. The relabeling itself still
    touches the whole CSR (it has to produce the reordered graph).

    Reordering an already-reordered graph is rejected: permutations would
    have to be composed and no call site needs that.
    """
    if method == "identity":
        return g
    if method not in REORDER_METHODS:
        raise ValueError(f"unknown reorder method {method!r}; pick from {REORDER_METHODS}")
    if g.perm is not None:
        raise ValueError("graph is already reordered; compose orders explicitly if needed")
    if sample_edges is not None:
        perm = sampled_order(g, method, edge_budget=sample_edges)
    else:
        perm = bfs_order(g) if method == "bfs" else rcm_order(g)
    return permute_graph(g, perm)


def bitmap_density(bg: BucketedGraph) -> float:
    """Fraction of set bits in the bucket-adjacency bitmap (1.0 = the static
    frontier filter can never rule out any tile; lower = sparser = better).

    1.0 for graphs with fewer than two tiles (nothing to filter)."""
    adj = bg.bucket_adjacency()
    if adj.size <= 1:
        return 1.0
    return float(adj.mean())


def neighbor_spans(g: Graph) -> np.ndarray:
    """Per-node neighbor-id span ``max(N(v)) - min(N(v)) + 1`` (0 for
    isolated nodes) — the locality profile the tile autotuner reads.

    CSR rows are sorted by construction (``from_edges`` packs and sorts,
    relabeling is monotone or re-sorted), so the span is last-minus-first.
    """
    span = np.zeros(g.n_nodes, dtype=np.int64)
    nz = np.nonzero(g.degrees > 0)[0]
    span[nz] = (
        g.indices[g.indptr[nz + 1] - 1].astype(np.int64)
        - g.indices[g.indptr[nz]].astype(np.int64)
        + 1
    )
    return span
