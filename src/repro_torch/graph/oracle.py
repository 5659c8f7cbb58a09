"""Coreness oracles for correctness testing.

:func:`peel_coreness` is the Batagelj–Zaversnik bucket-queue peeling
algorithm (O(n + m), numpy) — the classical exact algorithm the paper's
Section 2 starts from. :func:`nx_coreness` wraps networkx as an independent
second opinion; tests cross-check all engines against these.

:func:`peel_kcore_mask` extracts the exact k-core membership mask — the
paper's *Exact-Divide* extraction primitive.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structs import Graph


def peel_coreness(g: Graph) -> np.ndarray:
    """Exact coreness via BZ peeling. Returns ``[n_nodes]`` int32."""
    n = g.n_nodes
    deg = g.degrees.astype(np.int64).copy()
    indptr, indices = g.indptr, g.indices

    # Bucket sort nodes by degree.
    max_deg = int(deg.max(initial=0))
    bin_start = np.zeros(max_deg + 2, dtype=np.int64)
    np.cumsum(np.bincount(deg, minlength=max_deg + 1), out=bin_start[1:])
    order = np.argsort(deg, kind="stable").astype(np.int64)
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    bin_ptr = bin_start[:-1].copy()  # current start of each degree bin

    core = deg.copy()
    for i in range(n):
        v = order[i]
        dv = core[v]
        for u in indices[indptr[v] : indptr[v + 1]]:
            if core[u] > dv:
                du = core[u]
                # Swap u with the first node of its bin, shrink the bin.
                pu, pw = pos[u], bin_ptr[du]
                w = order[pw]
                if u != w:
                    order[pu], order[pw] = w, u
                    pos[u], pos[w] = pw, pu
                bin_ptr[du] += 1
                core[u] -= 1
    return core.astype(np.int32)


def nx_coreness(g: Graph) -> np.ndarray:
    """networkx cross-check (slow; tests only)."""
    import networkx as nx

    G = nx.Graph()
    G.add_nodes_from(range(g.n_nodes))
    src = np.repeat(np.arange(g.n_nodes), g.degrees)
    G.add_edges_from(zip(src.tolist(), g.indices.tolist()))
    cores = nx.core_number(G)
    return np.array([cores[i] for i in range(g.n_nodes)], dtype=np.int32)


def peel_kcore_mask(g: Graph, k: int) -> np.ndarray:
    """Exact k-core membership mask by iterative removal of deg<k nodes."""
    alive = np.ones(g.n_nodes, dtype=bool)
    deg = g.degrees.astype(np.int64).copy()
    src = np.repeat(np.arange(g.n_nodes, dtype=np.int64), g.degrees)
    frontier = np.nonzero(alive & (deg < k))[0]
    while frontier.size:
        alive[frontier] = False
        f = np.zeros(g.n_nodes, dtype=bool)
        f[frontier] = True
        # Decrement degrees of alive neighbors of removed nodes.
        hits = f[src] & alive[g.indices]
        dec = np.bincount(g.indices[hits], minlength=g.n_nodes)
        deg -= dec
        frontier = np.nonzero(alive & (deg < k) & (dec > 0))[0]
    return alive
