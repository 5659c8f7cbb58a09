"""Graph IO: npz snapshots, SNAP-style edge lists, and streaming ingest.

``load_edgelist`` accepts the com-friendster format (``u<TAB>v`` per line,
``#`` comments), so the paper's public dataset drops in directly when
present on disk.

The **streaming ingest path** builds the same CSR without ever holding the
full edge list in host memory — the out-of-core half of the paper's
limited-resources story (the device half is per-part division):

* :func:`iter_edgelist_chunks` parses an edge-list file into bounded
  ``(src, dst)`` chunks.
* :class:`EdgeStore` spills canonicalized directed slots (self-loops
  dropped, both directions) to disk, tracking duplicate-inclusive degree
  counts and the max node id — enough for
  :func:`~repro_torch.core.divide.plan_thresholds` and Rough-Divide to run before
  (or without) CSR materialization.
* :func:`csr_from_edge_store` finishes the build with an external bucket
  sort: slots are routed into node-range spill bins sized to the chunk
  budget, each bin is deduped independently
  (:func:`~repro_torch.graph.build.finalize_key_bin`), and the deduped runs
  concatenate — in ascending node order — into a CSR **bit-identical** to
  :meth:`Graph.from_edges <repro_torch.graph.structs.Graph.from_edges>`.

Host-resident transient memory is bounded by ``O(chunk + n_nodes)`` plus
the largest spill bin (``~total_slots / max_bins``, and never less than one
node's full adjacency — a row must be materialized to dedup it). The output
CSR itself is of course edge-sized; :class:`IngestStats` reports the
tracked transient peak next to what the in-memory loader would have held.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.graph.build import canonical_slots, finalize_key_bin
from repro_torch.graph.structs import Graph


def save_npz(path: str, g: Graph) -> None:
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, indptr=g.indptr, indices=g.indices, n_nodes=g.n_nodes)
    os.replace(tmp, path)


def load_npz(path: str) -> Graph:
    z = np.load(path)
    return Graph(indptr=z["indptr"], indices=z["indices"], n_nodes=int(z["n_nodes"]))


def load_edgelist(path: str, n_nodes: int | None = None) -> Graph:
    """Load a whitespace-separated edge list (SNAP format) fully in memory.

    Shares the line parser with the streaming path
    (:func:`iter_edgelist_chunks`) so the two loaders cannot diverge."""
    src, dst = [], []
    for s, d in iter_edgelist_chunks(path, chunk_edges=2**62):
        src.append(s)
        dst.append(d)
    cat = lambda parts: (  # noqa: E731
        np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
    )
    return Graph.from_edges(cat(src), cat(dst), n_nodes)


def save_edgelist(path: str, g: Graph, chunk_edges: int = 1 << 20) -> None:
    """Write each undirected edge once (``u < v``), in bounded chunks — no
    edge-sized source vector is ever materialized."""
    with open(path, "w") as f:
        for src, dst in graph_edge_chunks(g, chunk_edges):
            for u, v in zip(src, dst):
                f.write(f"{u}\t{v}\n")


# --------------------------------------------------------------------- #
# Streaming ingest
# --------------------------------------------------------------------- #

DEFAULT_CHUNK_EDGES = 1 << 20


@dataclasses.dataclass
class IngestStats:
    """Accounting of one streaming CSR build.

    ``peak_transient_bytes`` tracks the live numpy temporaries of the build
    (chunk buffers, spill-bin loads, the persistent ``O(n_nodes)`` count
    arrays) — everything *except* the output CSR, which any loader must
    produce. ``baseline_transient_bytes`` is the array working set the
    in-memory :meth:`Graph.from_edges` path holds for the same input
    (src/dst, the symmetrized u/v copies, the packed keys and their
    ``np.unique`` copy), excluding Python-list parse overhead — i.e. a
    *conservative* baseline. The acceptance gate is
    ``peak_transient_bytes < baseline_transient_bytes``, with the streaming
    side bounded by the chunk budget, not the edge count.
    """

    chunk_edges: int
    n_chunks: int = 0
    input_pairs: int = 0          # edge lines / pairs fed in
    slots_spilled: int = 0        # directed slots written to the spill store
    n_bins: int = 0
    spill_bytes: int = 0          # bytes written to disk across both phases
    peak_transient_bytes: int = 0
    output_bytes: int = 0

    def bump(self, live_bytes: int) -> None:
        self.peak_transient_bytes = max(self.peak_transient_bytes, int(live_bytes))

    @property
    def baseline_transient_bytes(self) -> int:
        # src + dst int64, u + v symmetrized copies, key + unique(key).
        return self.input_pairs * 16 + self.slots_spilled * 8 * 4


class EdgeStore:
    """Append-only on-disk store of canonicalized directed edge slots.

    ``append`` drops self-loops, symmetrizes, and spills both directed
    slots as interleaved ``(u, v)`` int64 pairs; only ``O(chunk)`` is ever
    resident. Alongside the spill it maintains:

    * ``dup_degrees(n)`` — per-node slot counts *including duplicates*
      (an upper bound on the true degree), enough for
      :func:`~repro_torch.core.divide.plan_thresholds` /
      :func:`~repro_torch.core.divide.rough_candidates` to run without the edge
      list or the CSR resident;
    * ``max_id`` — over raw input endpoints (self-loops included, matching
      ``Graph.from_edges`` node-count inference) — and ``max_slot_id`` over
      canonicalized slots only (``from_edges`` range-checks *after*
      dropping self-loops, so an out-of-range id appearing only in a
      self-loop must load, not raise).

    Use as a context manager (or call :meth:`cleanup`) to remove the spill
    directory; :func:`stream_edgelist` does this automatically.
    """

    def __init__(self, workdir: Optional[str] = None):
        self._own_dir = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(prefix="edgestore_")
        os.makedirs(self.workdir, exist_ok=True)
        self.path = os.path.join(self.workdir, "slots.i64")
        self._f = open(self.path, "wb")
        self._counts = np.zeros(1024, dtype=np.int64)
        self.max_id = -1       # over raw endpoints (self-loops included)
        self.max_slot_id = -1  # over canonicalized slots (loops dropped)
        self.n_slots = 0
        self.n_pairs = 0

    # -- ingest ---------------------------------------------------------- #
    def append(self, src: np.ndarray, dst: np.ndarray) -> None:
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        self.n_pairs += int(src.size)
        if src.size:
            self.max_id = max(
                self.max_id, int(src.max()), int(dst.max())
            )
        u, v = canonical_slots(src, dst)
        if u.size == 0:
            return
        top = int(u.max())
        self.max_slot_id = max(self.max_slot_id, top)
        if top >= self._counts.size:
            grown = np.zeros(max(2 * self._counts.size, top + 1), dtype=np.int64)
            grown[: self._counts.size] = self._counts
            self._counts = grown
        self._counts += np.bincount(u, minlength=self._counts.size)
        pairs = np.empty(2 * u.size, dtype=np.int64)
        pairs[0::2] = u
        pairs[1::2] = v
        pairs.tofile(self._f)
        self.n_slots += int(u.size)

    def dup_degrees(self, n_nodes: int) -> np.ndarray:
        """[n_nodes] duplicate-inclusive slot counts (true degree <= this)."""
        out = np.zeros(n_nodes, dtype=np.int64)
        m = min(n_nodes, self._counts.size)
        out[:m] = self._counts[:m]
        return out

    # -- read back ------------------------------------------------------- #
    def iter_slots(self, chunk_slots: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ``(u, v)`` int64 chunks of at most ``chunk_slots`` slots."""
        self.flush()
        chunk_slots = max(1, int(chunk_slots))
        with open(self.path, "rb") as f:
            while True:
                buf = np.fromfile(f, dtype=np.int64, count=2 * chunk_slots)
                if buf.size == 0:
                    return
                yield buf[0::2], buf[1::2]

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()

    @property
    def spill_bytes(self) -> int:
        return self.n_slots * 16

    # -- lifecycle ------------------------------------------------------- #
    def cleanup(self) -> None:
        if not self._f.closed:
            self._f.close()
        if self._own_dir:
            shutil.rmtree(self.workdir, ignore_errors=True)

    def __enter__(self) -> "EdgeStore":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()


def _plan_bins(counts_dup: np.ndarray, budget_slots: int, max_bins: int) -> np.ndarray:
    """Node-range bin boundaries for the external dedup.

    Returns ascending ``bounds`` with ``bounds[0] == 0`` and
    ``bounds[-1] == n``; bin ``i`` owns sources in
    ``[bounds[i], bounds[i+1])``. Each bin targets at most ``budget_slots``
    duplicate-inclusive slots but never splits a single node (a CSR row is
    deduped whole), and the bin count is capped at ``max_bins`` so a tiny
    chunk budget cannot explode the open-file count — the documented
    transient bound is ``max(chunk, total / max_bins, largest row)``.
    """
    n = counts_dup.size
    total = int(counts_dup.sum())
    if n == 0 or total == 0:
        return np.array([0, n], dtype=np.int64)
    n_bins = int(min(max_bins, max(1, -(-total // max(1, budget_slots)))))
    cum = np.cumsum(counts_dup)
    targets = (np.arange(1, n_bins, dtype=np.float64) * total) / n_bins
    cuts = np.searchsorted(cum, targets, side="left") + 1
    bounds = np.unique(np.concatenate([[0], cuts, [n]]))
    return bounds.astype(np.int64)


def csr_from_edge_store(
    store: EdgeStore,
    n_nodes: Optional[int] = None,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    max_bins: int = 256,
    stats: Optional[IngestStats] = None,
    keep_mask: Optional[np.ndarray] = None,
) -> Tuple[Graph, IngestStats]:
    """Materialize the CSR from a spilled :class:`EdgeStore`.

    External bucket sort in two bounded passes over the spill: (1) route
    packed keys into node-range bins planned from the duplicate-inclusive
    degree counts; (2) dedup each bin independently and stream its rows
    into the final ``indices`` file, read back once into the output array.
    Bit-identical to ``Graph.from_edges`` on the same input.

    ``keep_mask`` (``[n_nodes]`` bool) restricts the build to the **induced
    subgraph** on the kept nodes, relabeled ascending — the divide step's
    extraction fused into the same two bounded passes: slots are filtered
    and relabeled on the way into the bins, so the first part of a streamed
    pipeline never materializes the full CSR. Relabeling is monotone and
    ``np.unique``'s order is u-major/v-minor either way, so the result is
    bit-identical to ``induced_subgraph(csr_from_edge_store(store), mask)``
    at every chunk size.
    """
    if stats is None:
        stats = IngestStats(chunk_edges=int(chunk_edges))
    if n_nodes is None:
        n_nodes = store.max_id + 1  # raw max: from_edges infers pre-loop-drop
    n = int(n_nodes)
    if store.max_slot_id >= n:
        # Range check on canonicalized slots only, like from_edges — an
        # out-of-range id appearing only in a dropped self-loop is legal.
        raise ValueError("edge endpoint out of range")
    stats.input_pairs = store.n_pairs
    stats.slots_spilled = store.n_slots

    counts_dup = store.dup_degrees(n)
    if keep_mask is not None:
        keep_mask = np.asarray(keep_mask, dtype=bool)
        if keep_mask.shape != (n,):
            raise ValueError("mask shape mismatch")
        new_id = np.full(n, -1, dtype=np.int64)
        n_out = int(keep_mask.sum())
        new_id[keep_mask] = np.arange(n_out, dtype=np.int64)
        # Dup counts of kept rows (slots into dropped neighbors included —
        # a conservative upper bound is all bin planning needs).
        counts_dup = counts_dup[keep_mask]
    else:
        new_id = None
        n_out = n
    budget_slots = max(1, 2 * int(chunk_edges))
    bounds = _plan_bins(counts_dup, budget_slots, max_bins)
    n_bins = int(bounds.size - 1)
    stats.n_bins = n_bins
    stats.bump(counts_dup.nbytes * 2)  # counts + cumsum in _plan_bins

    bin_dir = os.path.join(store.workdir, "bins")
    os.makedirs(bin_dir, exist_ok=True)
    try:
        # Pass 1: route slots into per-bin key spills (mask-filtered and
        # relabeled first on the induced path).
        bin_files = [
            open(os.path.join(bin_dir, f"bin_{i:05d}.i64"), "wb")
            for i in range(n_bins)
        ]
        try:
            for u, v in store.iter_slots(budget_slots):
                raw_bytes = 0
                if new_id is not None:
                    kept = keep_mask[u] & keep_mask[v]
                    # The unfiltered chunk (u, v, kept mask) is still live
                    # while the filtered copies below exist — count it.
                    raw_bytes = u.nbytes * 2 + kept.nbytes
                    u, v = new_id[u[kept]], new_id[v[kept]]
                key = u * np.int64(n_out) + v
                if n_bins == 1:
                    stats.bump(counts_dup.nbytes + raw_bytes + u.nbytes * 3)
                    key.tofile(bin_files[0])
                else:
                    # Route via one stable sort + contiguous slices —
                    # O(c log c) per chunk, not O(n_bins * c) masking.
                    bi = np.searchsorted(bounds, u, side="right") - 1
                    order = np.argsort(bi, kind="stable")
                    key_sorted = key[order]
                    run_counts = np.bincount(bi, minlength=n_bins)
                    offs = np.concatenate([[0], np.cumsum(run_counts)])
                    stats.bump(counts_dup.nbytes + raw_bytes + u.nbytes * 6)
                    for b in np.nonzero(run_counts)[0]:
                        key_sorted[offs[b] : offs[b + 1]].tofile(bin_files[b])
                stats.spill_bytes += key.nbytes
        finally:
            for f in bin_files:
                f.close()
        stats.spill_bytes += store.spill_bytes

        # Pass 2: dedup each bin in node order; rows concatenate into the
        # final indices stream.
        counts = np.zeros(n_out, dtype=np.int64)
        idx_path = os.path.join(bin_dir, "indices.i32")
        with open(idx_path, "wb") as idx_f:
            for i in range(n_bins):
                keys = np.fromfile(os.path.join(bin_dir, f"bin_{i:05d}.i64"), dtype=np.int64)
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                bin_counts, neigh = finalize_key_bin(keys, n_out, lo, hi)
                counts[lo:hi] = bin_counts
                neigh.tofile(idx_f)
                stats.bump(
                    counts_dup.nbytes + counts.nbytes
                    + keys.nbytes * 2 + bin_counts.nbytes + neigh.nbytes
                )
        indptr = np.zeros(n_out + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        indices = np.fromfile(idx_path, dtype=np.int32)
    finally:
        shutil.rmtree(bin_dir, ignore_errors=True)

    g = Graph(indptr=indptr, indices=indices, n_nodes=n_out)
    stats.output_bytes = g.memory_bytes()
    stats.bump(counts.nbytes + counts_dup.nbytes)
    return g, stats


def induced_subgraph_from_store(
    store: EdgeStore,
    keep_mask: np.ndarray,
    n_nodes: Optional[int] = None,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    max_bins: int = 256,
    stats: Optional[IngestStats] = None,
) -> Tuple[Graph, np.ndarray, IngestStats]:
    """Divide-step extraction directly over the spill: the induced subgraph
    on ``keep_mask``, built without the full CSR ever resident.

    Returns ``(subgraph, node_ids, stats)`` with the same
    ``node_ids[new_id] = old_id`` contract as
    :func:`~repro_torch.graph.build.induced_subgraph`, to which the result is
    bit-identical (composed with :func:`csr_from_edge_store` on the same
    store). With :func:`~repro_torch.core.divide.rough_candidates_from_store`
    supplying the mask from the store's duplicate-inclusive degrees, the
    first (densest) part of a streamed DC-kCore run goes edge-list ->
    part CSR under the chunk budget end to end.
    """
    if n_nodes is None:
        n_nodes = store.max_id + 1
    keep_mask = np.asarray(keep_mask, dtype=bool)
    g, stats = csr_from_edge_store(
        store, n_nodes, chunk_edges=chunk_edges, max_bins=max_bins,
        stats=stats, keep_mask=keep_mask,
    )
    return g, np.nonzero(keep_mask)[0].astype(np.int64), stats


def csr_from_edge_chunks(
    chunks: Iterable[Tuple[np.ndarray, np.ndarray]],
    n_nodes: Optional[int] = None,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    max_bins: int = 256,
    workdir: Optional[str] = None,
) -> Tuple[Graph, IngestStats]:
    """Chunked equivalent of ``Graph.from_edges``: consume an iterable of
    bounded ``(src, dst)`` chunks and return the bit-identical CSR plus
    :class:`IngestStats`. The full edge list is never resident — chunks are
    spilled through an :class:`EdgeStore` and deduped externally.
    """
    stats = IngestStats(chunk_edges=int(chunk_edges))
    with EdgeStore(workdir=workdir) as store:
        for src, dst in chunks:
            store.append(src, dst)
            stats.n_chunks += 1
            stats.bump(np.asarray(src).size * 8 * 6 + store._counts.nbytes)
        return csr_from_edge_store(
            store, n_nodes, chunk_edges=chunk_edges, max_bins=max_bins, stats=stats
        )


def iter_edgelist_chunks(
    path: str, chunk_edges: int = DEFAULT_CHUNK_EDGES
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Parse a SNAP edge list into bounded ``(src, dst)`` int64 chunks.

    Same line semantics as :func:`load_edgelist` (``#`` comments and blank
    lines skipped, first two whitespace tokens per line).
    """
    chunk_edges = max(1, int(chunk_edges))
    src: List[int] = []
    dst: List[int] = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            a, b = line.split()[:2]
            src.append(int(a))
            dst.append(int(b))
            if len(src) >= chunk_edges:
                yield np.array(src, dtype=np.int64), np.array(dst, dtype=np.int64)
                src, dst = [], []
    if src:
        yield np.array(src, dtype=np.int64), np.array(dst, dtype=np.int64)


def stream_edgelist(
    path: str,
    n_nodes: Optional[int] = None,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    max_bins: int = 256,
    workdir: Optional[str] = None,
) -> Tuple[Graph, IngestStats]:
    """Streaming counterpart of :func:`load_edgelist`.

    Reads the file in ``chunk_edges``-sized chunks, spills through an
    :class:`EdgeStore`, and materializes the CSR with the external dedup —
    bit-identical to ``load_edgelist(path, n_nodes)`` at every chunk size.
    """
    return csr_from_edge_chunks(
        iter_edgelist_chunks(path, chunk_edges),
        n_nodes=n_nodes,
        chunk_edges=chunk_edges,
        max_bins=max_bins,
        workdir=workdir,
    )


def graph_edge_chunks(
    g: Graph, chunk_edges: int = DEFAULT_CHUNK_EDGES
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield a graph's undirected edges (each once, ``u < v``) in bounded
    chunks — the adapter that lets synthetic/in-memory graphs exercise and
    benchmark the streaming build path."""
    chunk_edges = max(1, int(chunk_edges))
    n = g.n_nodes
    row = 0
    src_buf: List[np.ndarray] = []
    dst_buf: List[np.ndarray] = []
    buffered = 0
    while row < n:
        # Grow the row window until it holds at least one chunk of slots.
        hi = row
        while hi < n and int(g.indptr[hi + 1] - g.indptr[row]) < 2 * chunk_edges:
            hi += 1
        hi = min(max(hi, row + 1), n)
        lo_ptr, hi_ptr = int(g.indptr[row]), int(g.indptr[hi])
        cols = g.indices[lo_ptr:hi_ptr].astype(np.int64)
        srcs = np.repeat(
            np.arange(row, hi, dtype=np.int64),
            np.diff(g.indptr[row : hi + 1]).astype(np.int64),
        )
        keep = srcs < cols  # each undirected edge exactly once
        srcs, cols = srcs[keep], cols[keep]
        src_buf.append(srcs)
        dst_buf.append(cols)
        buffered += int(srcs.size)
        row = hi
        while buffered >= chunk_edges or (row >= n and buffered > 0):
            src = np.concatenate(src_buf) if len(src_buf) > 1 else src_buf[0]
            dst = np.concatenate(dst_buf) if len(dst_buf) > 1 else dst_buf[0]
            yield src[:chunk_edges], dst[:chunk_edges]
            src_buf, dst_buf = [src[chunk_edges:]], [dst[chunk_edges:]]
            buffered = int(src_buf[0].size)
