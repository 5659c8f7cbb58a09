"""Synthetic graph generators (numpy, reproducible).

The paper evaluates on com-friendster (public, 1.8B edges) and two internal
payment graphs (15B / 136B edges). None fit this container; benchmarks use
*shape-matched* synthetic graphs instead:

* :func:`barabasi_albert` — preferential attachment; heavy-tailed degrees
  like social graphs (com-friendster analogue).
* :func:`rmat` — Kronecker-style power-law generator used by Graph500;
  closest to payment-network skew (WX-* analogue).
* :func:`erdos_renyi` — uniform random baseline for property tests.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structs import Graph


def erdos_renyi(n: int, avg_deg: float, seed: int = 0) -> Graph:
    """G(n, m) with m = n * avg_deg / 2 sampled edge pairs."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    return Graph.from_edges(src, dst, n_nodes=n)


def barabasi_albert(n: int, m: int, seed: int = 0) -> Graph:
    """Preferential attachment: each new node attaches to ``m`` targets.

    Vectorized variant: targets are sampled from the repeated-endpoint pool
    (the classic BA trick), giving the expected power-law degree tail.
    """
    if n <= m:
        raise ValueError("need n > m")
    rng = np.random.default_rng(seed)
    src = np.empty((n - m - 1) * m, dtype=np.int64)
    dst = np.empty_like(src)
    # Seed clique-ish core on the first m+1 nodes.
    seed_src = np.repeat(np.arange(m + 1), m + 1)
    seed_dst = np.tile(np.arange(m + 1), m + 1)
    pool = np.concatenate([seed_src, seed_dst]).tolist()
    pool_arr = np.array(pool, dtype=np.int64)
    pool_len = pool_arr.shape[0]
    cap = pool_len + 2 * m * n
    buf = np.empty(cap, dtype=np.int64)
    buf[:pool_len] = pool_arr
    w = 0
    for v in range(m + 1, n):
        picks = buf[rng.integers(0, pool_len, size=m)]
        src[w : w + m] = v
        dst[w : w + m] = picks
        w += m
        buf[pool_len : pool_len + m] = v
        buf[pool_len + m : pool_len + 2 * m] = picks
        pool_len += 2 * m
    edges_src = np.concatenate([seed_src, src])
    edges_dst = np.concatenate([seed_dst, dst])
    return Graph.from_edges(edges_src, edges_dst, n_nodes=n)


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0) -> Graph:
    """R-MAT/Kronecker generator (Graph500 defaults)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # Quadrant probabilities a, b, c, d.
        src_bit = r >= (a + b)
        dst_bit = ((r >= a) & (r < a + b)) | (r >= (a + b + c))
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    return Graph.from_edges(src, dst, n_nodes=n)
