"""Graph containers.

``Graph`` is the host-side representation: undirected simple graph in CSR
form (numpy, int32). Construction symmetrizes, removes self-loops and
deduplicates parallel edges, so every downstream component can assume a
simple undirected graph — the setting of the paper.

``BucketedGraph`` is the device-ready representation: nodes are grouped by
degree into power-of-two-width buckets and each bucket's adjacency is padded
to a dense ``[nodes, width]`` tile. Dense tiles are what the TPU wants
(lane-aligned loads, compare-and-reduce on the VPU) and bound the padding
overhead by 2x; this replaces the paper's vertex-centric RDD partitions.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected simple graph in CSR form.

    Attributes:
      indptr:  ``[n_nodes + 1]`` int64 row offsets.
      indices: ``[2 * n_edges]`` int32 neighbor ids (both directions stored).
      n_nodes: number of vertices.
      perm:    optional ``[n_nodes]`` int64 layout permutation,
               ``perm[new_id] = old_id`` — set by
               :func:`~repro_torch.graph.reorder.reorder_graph` when the CSR has
               been relabeled into a locality-aware order. ``None`` means
               the CSR is in original-id order.
      inv_perm: the inverse (``inv_perm[old_id] = new_id``); set iff
               ``perm`` is.

    When ``perm`` is set, the CSR arrays index *new* (reordered) ids, but
    the public contract stays original-id: :func:`~repro_torch.graph.build.bucketize`
    permutes ``ext`` inputs in, and the decompose engines permute coreness
    outputs back, so callers never see reordered ids.
    """

    indptr: np.ndarray
    indices: np.ndarray
    n_nodes: int
    perm: Optional[np.ndarray] = None
    inv_perm: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ #
    # Constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: Optional[int] = None) -> "Graph":
        """Build from a (possibly directed / duplicated) edge list.

        Self-loops are dropped; the edge set is symmetrized and deduplicated.
        Expressed through the same chunk-level steps the streaming ingest
        uses (:func:`~repro_torch.graph.build.canonical_slots` +
        :func:`~repro_torch.graph.build.finalize_key_bin` over the single bin
        ``[0, n)``), so the two build paths are bit-identical by
        construction, not just by test.
        """
        # Late import: build.py imports this module at load time.
        from repro_torch.graph.build import canonical_slots, finalize_key_bin

        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if n_nodes is None:
            n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        u, v = canonical_slots(src, dst)
        if u.size and max(u.max(), v.max()) >= n_nodes:
            raise ValueError("edge endpoint out of range")
        counts, indices = finalize_key_bin(
            u * np.int64(n_nodes) + v, int(n_nodes), 0, int(n_nodes)
        )
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return Graph(indptr=indptr, indices=indices, n_nodes=int(n_nodes))

    @staticmethod
    def empty(n_nodes: int) -> "Graph":
        return Graph(
            indptr=np.zeros(n_nodes + 1, dtype=np.int64),
            indices=np.zeros(0, dtype=np.int32),
            n_nodes=n_nodes,
        )

    # ------------------------------------------------------------------ #
    # Views
    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        """Number of undirected edges."""
        return self.indices.shape[0] // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def memory_bytes(self) -> int:
        """Host bytes of the CSR arrays (the paper's 'resource' unit)."""
        return self.indptr.nbytes + self.indices.nbytes

    def validate(self) -> None:
        deg = self.degrees
        assert deg.min(initial=0) >= 0
        assert self.indptr[-1] == self.indices.shape[0]
        if self.indices.size:
            assert self.indices.min() >= 0 and self.indices.max() < self.n_nodes


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A degree bucket of padded dense adjacency.

    Attributes:
      node_ids:  ``[nb]`` int32 original node ids (padded rows use the
                 sentinel id ``n_nodes``).
      neigh:     ``[nb, width]`` int32 neighbor ids, padded with ``n_nodes``
                 (the sentinel row of the gathered coreness vector).
      deg:       ``[nb]`` int32 true in-part degree per row (0 for pad rows).
      width:     static pad width (power of two).
    """

    node_ids: np.ndarray
    neigh: np.ndarray
    deg: np.ndarray
    width: int

    @property
    def n_rows(self) -> int:
        return self.node_ids.shape[0]

    def memory_bytes(self) -> int:
        return self.node_ids.nbytes + self.neigh.nbytes + self.deg.nbytes


@dataclasses.dataclass(frozen=True)
class BucketedGraph:
    """Degree-bucketed padded adjacency for a (sub)graph part.

    ``ext`` carries the paper's *external information* E(v) per node
    (``0`` for a monolithic decomposition). ``n_nodes`` is the node count of
    the part; neighbor ids in buckets index into ``[0, n_nodes]`` where
    ``n_nodes`` is the padding sentinel.

    ``bucket_adj`` is the symmetric ``[n_buckets, n_buckets]`` bool bitmap of
    bucket adjacency: ``bucket_adj[i, j]`` iff some node in bucket ``i`` has
    a neighbor in bucket ``j`` (diagonal always set). Computed once at
    :func:`~repro_torch.graph.build.bucketize` time, it makes active-frontier sweep
    scheduling *sound*: a bucket whose own rows and whose adjacent buckets
    were all quiescent last sweep cannot change this sweep, so the engines
    skip its gather + h-index outright.

    ``perm``/``inv_perm`` (propagated from a reordered source
    :class:`Graph`) record the layout permutation the tiles were built in:
    node ids inside the buckets are *new* (reordered) ids, ``ext`` and
    ``degrees`` are stored in new-id order, and the decompose engines gather
    ``coreness[inv_perm]`` on the way out so results are reported in
    original-id order. ``None`` = identity layout.
    """

    n_nodes: int
    buckets: List[Bucket]
    ext: np.ndarray  # [n_nodes] int32
    degrees: np.ndarray  # [n_nodes] int32, in-part degree
    bucket_adj: Optional[np.ndarray] = None  # [n_buckets, n_buckets] bool
    node_bucket: Optional[np.ndarray] = None  # [n_nodes + 1] int32, -1 = none
    perm: Optional[np.ndarray] = None  # [n_nodes] int64, new -> old
    inv_perm: Optional[np.ndarray] = None  # [n_nodes] int64, old -> new

    def memory_bytes(self) -> int:
        return int(
            sum(b.memory_bytes() for b in self.buckets) + self.ext.nbytes + self.degrees.nbytes
        )

    def bucket_adjacency(self) -> np.ndarray:
        """The bucket-adjacency bitmap; all-True (always rescan every bucket,
        the pre-frontier behavior) when none was recorded at build time."""
        nb = len(self.buckets)
        if self.bucket_adj is not None:
            assert self.bucket_adj.shape == (nb, nb)
            return self.bucket_adj
        return np.ones((nb, nb), dtype=bool)

    def node_bucket_map(self) -> np.ndarray:
        """[n_nodes + 1] node -> owning bucket index (-1 for degree-0 nodes
        and the sentinel slot). Recorded at bucketize time; derived from the
        buckets when absent (hand-built instances)."""
        if self.node_bucket is not None:
            return self.node_bucket
        m = np.full(self.n_nodes + 1, -1, dtype=np.int32)
        for bi, b in enumerate(self.buckets):
            real = b.node_ids[b.node_ids < self.n_nodes]
            m[real] = bi
        return m

    @property
    def rows_per_full_sweep(self) -> int:
        """Bucket rows a full (non-frontier) sweep gathers, padding included."""
        return int(sum(b.n_rows for b in self.buckets))

    @property
    def widths(self) -> Sequence[int]:
        return [b.width for b in self.buckets]

    @property
    def padded_slots(self) -> int:
        return int(sum(b.neigh.size for b in self.buckets))


def from_reference_arrays(ref):
    """The port's :class:`Graph` or :class:`BucketedGraph` holding the numpy
    arrays of an equivalent object of the JAX package (``repro.graph``).

    Duck-typed on the fields, so this module imports nothing of that
    package; tests use it to hand one graph to both packages. The arrays
    are shared, not copied (both packages treat them as read-only).
    """
    if hasattr(ref, "buckets"):
        return BucketedGraph(
            n_nodes=int(ref.n_nodes),
            buckets=[
                Bucket(node_ids=b.node_ids, neigh=b.neigh, deg=b.deg,
                       width=int(b.width))
                for b in ref.buckets
            ],
            ext=ref.ext,
            degrees=ref.degrees,
            bucket_adj=ref.bucket_adj,
            node_bucket=ref.node_bucket,
            perm=ref.perm,
            inv_perm=ref.inv_perm,
        )
    return Graph(indptr=ref.indptr, indices=ref.indices, n_nodes=int(ref.n_nodes),
                 perm=ref.perm, inv_perm=ref.inv_perm)
