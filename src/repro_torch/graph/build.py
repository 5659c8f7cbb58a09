"""Builders: bucketing, induced subgraphs and external information.

These are the host-side preprocessing steps of DC-kCore:

* :func:`induced_subgraph` implements the divide step's subgraph extraction
  (with old->new relabeling), for both Exact- and Rough-Divide. It runs as
  **chunked passes over CSR row ranges**: per-chunk transient host bytes are
  bounded by ``chunk_slots``, never by the edge count, and the output CSR is
  bit-identical at every chunk size (row ranges preserve the parent CSR's
  row-major, column-sorted emission order under the monotone relabeling).
* :func:`external_info` implements Definition 3 of the paper:
  ``E(v) = |N_G(v) ∩ V_upper|`` for every surviving node ``v`` — same
  chunked row-range structure. Both take a ``device``: the same pass as
  torch ops on that device (a GPU's memory holds the whole graph's slots),
  to the same arrays.
* :class:`DivideStats` tracks the divide step's peak transient host bytes
  against the dense (``np.repeat``-over-all-rows) baseline, mirroring
  :class:`~repro_torch.graph.io.IngestStats` for the ingest step.
* :func:`bucketize` converts a CSR part into the TPU-friendly
  degree-bucketed padded representation, splitting degree classes into
  row-tiles whose size is chosen by :func:`autotune_tile_caps` from the
  part's degree/locality profile (the ``max_bucket_rows="auto"`` path).
* :func:`canonical_slots` / :func:`finalize_key_bin` are the pure per-chunk
  steps of the streaming CSR build (:mod:`repro_torch.graph.io`): chunk-local
  canonicalization on the way into the spill store, and per-node-range
  dedup + degree counting on the way out. Together they reproduce
  :meth:`Graph.from_edges <repro_torch.graph.structs.Graph.from_edges>`
  bit-for-bit without ever holding the full edge list.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.graph.structs import Bucket, BucketedGraph, Graph
from repro_torch.trace import span, spanned

# Bucket pad widths: powers of two. Smallest kept modest so tiny-degree nodes
# don't blow up the padded footprint; largest grows to cover any max degree.
_MIN_WIDTH = 8

# Default chunk budget (in adjacency slots, i.e. directed edges) of the
# chunked divide passes. One chunk's int64 temporaries are ~25 bytes/slot,
# so the default bounds the divide transient at ~100 MiB regardless of
# graph size; graphs smaller than this run in a single chunk, so the small
# fixtures pay no chunking overhead at all.
DEFAULT_DIVIDE_CHUNK_SLOTS = 1 << 22


@dataclasses.dataclass
class DivideStats:
    """Transient-byte accounting of one chunked divide pass (or several —
    :func:`~repro_torch.core.dckcore.dc_kcore` threads one instance through all of
    a part's extraction calls).

    ``peak_transient_bytes`` tracks the live numpy temporaries of the
    chunked passes — the per-chunk source/column/mask arrays plus the
    persistent ``O(n)`` relabeling and count arrays — everything *except*
    the output CSR, which any extraction must produce.
    ``baseline_transient_bytes`` is what the dense (pre-chunking)
    implementation would have peaked at for the same calls: each function
    reports its own dense working-set model through :meth:`note_pass`
    (e.g. ``np.repeat`` source + edge mask over all slots, compacted
    pairs over kept slots), and the baseline is the **max** over the
    noted passes — the dense code held one pass's transient at a time, so
    summing would overstate the comparison. The regression gate is
    ``peak_transient_bytes < baseline_transient_bytes`` with the peak
    scaling with ``chunk_slots``, not the edge count.

    **Thread safety.** An instance is plain mutable state and must be owned
    by exactly one thread at a time. The extraction passes themselves
    (:func:`induced_subgraph`, :func:`external_info`,
    :func:`~repro_torch.core.divide.exact_candidates`) touch no shared mutable
    state — they read their argument arrays and write fresh outputs — so
    the overlapped pipeline's prefetch worker runs them concurrently with
    the main thread by giving each stage its *own* ``DivideStats`` and
    folding them together afterwards with :meth:`merge`.
    """

    chunk_slots: int
    n_chunks: int = 0
    input_slots: int = 0   # slots scanned across all chunked passes
    kept_slots: int = 0    # slots surviving the masks across all passes
    peak_transient_bytes: int = 0
    baseline_transient_bytes: int = 0

    def merge(self, other: "DivideStats") -> None:
        """Fold another pass's accounting into this one (counter sums, peak
        and baseline maxes). Because :meth:`bump` and :meth:`note_pass` are
        max-reductions and the counters are sums, threading one instance
        through two passes and merging two per-pass instances record the
        **same** numbers — which is what keeps the overlapped pipeline's
        per-part reports byte-identical to the sequential schedule's."""
        self.n_chunks += other.n_chunks
        self.input_slots += other.input_slots
        self.kept_slots += other.kept_slots
        self.peak_transient_bytes = max(
            self.peak_transient_bytes, other.peak_transient_bytes
        )
        self.baseline_transient_bytes = max(
            self.baseline_transient_bytes, other.baseline_transient_bytes
        )

    def bump(self, live_bytes: int) -> None:
        self.peak_transient_bytes = max(self.peak_transient_bytes, int(live_bytes))

    def note_pass(self, slots: int, kept: int,
                  slot_bytes: int = 9, kept_bytes: int = 20) -> None:
        """Record one dense-equivalent pass: ``slot_bytes`` per scanned slot
        (source vector + masks) plus ``kept_bytes`` per surviving slot
        (compacted/relabeled copies); the caller supplies the constants of
        its own dense model. The baseline keeps the max."""
        self.baseline_transient_bytes = max(
            self.baseline_transient_bytes,
            int(slots) * int(slot_bytes) + int(kept) * int(kept_bytes),
        )


def _resolve_chunk_slots(chunk_slots: Optional[int]) -> int:
    if chunk_slots is None:
        return DEFAULT_DIVIDE_CHUNK_SLOTS
    return max(1, int(chunk_slots))


def iter_row_ranges(indptr: np.ndarray, chunk_slots: int) -> Iterator[Tuple[int, int]]:
    """Yield CSR row ranges ``(lo, hi)`` holding at most ``chunk_slots``
    adjacency slots each — the unit of every chunked divide pass.

    A single row wider than the budget becomes its own over-budget range
    (a CSR row is indivisible here, like a dedup bin in
    :func:`~repro_torch.graph.io._plan_bins`); every range holds at least one row
    so the scan always terminates.
    """
    n = indptr.shape[0] - 1
    chunk_slots = max(1, int(chunk_slots))
    lo = 0
    while lo < n:
        hi = int(np.searchsorted(indptr, int(indptr[lo]) + chunk_slots, side="right")) - 1
        hi = min(max(hi, lo + 1), n)
        yield lo, hi
        lo = hi


def _iter_adjacency_chunks(g: Graph, chunk_slots: int):
    """Yield ``(lo, hi, src, cols)`` per row range: the range's column slice
    (a view into the CSR) and its row-aligned source vector — the shared
    chunk body of every chunked divide pass."""
    for lo, hi in iter_row_ranges(g.indptr, chunk_slots):
        cols = g.indices[g.indptr[lo] : g.indptr[hi]]  # contiguous view
        src = np.repeat(
            np.arange(lo, hi, dtype=np.int64),
            np.diff(g.indptr[lo : hi + 1]).astype(np.int64),
        )
        yield lo, hi, src, cols


def _bucket_widths(max_deg: int) -> Sequence[int]:
    widths = []
    w = _MIN_WIDTH
    while True:
        widths.append(w)
        if w >= max_deg:
            break
        w *= 2
    return widths


def _degree_classes(deg: np.ndarray):
    """Yield ``(width, member_ids)`` per non-empty power-of-two degree class.

    The single source of the class boundaries — :func:`bucketize` tiles by
    it and :func:`autotune_tile_caps` keys its caps by it, so the two can
    never disagree about which class a node falls in. ``member_ids`` are
    ascending (the order tiles are cut in); degree-0 nodes belong to no
    class.
    """
    max_deg = int(deg.max(initial=0))
    if max_deg == 0:
        return
    for lo_excl_idx, width in enumerate(_bucket_widths(max_deg)):
        lo = 0 if lo_excl_idx == 0 else width // 2
        members = np.nonzero((deg > lo) & (deg <= width))[0]
        if members.size:
            yield width, members


def canonical_slots(src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Canonicalize one edge chunk: drop self-loops, emit both directed slots.

    This is the symmetrization step of :meth:`Graph.from_edges` applied to a
    bounded chunk — no dedup (duplicates across chunks cannot be seen here;
    :func:`finalize_key_bin` removes them globally). Negative endpoints are
    rejected immediately so a bad line surfaces at ingest time, not after
    the whole file has been spilled.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    if src.size and (src.min() < 0 or dst.min() < 0):
        raise ValueError("edge endpoint out of range")
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def finalize_key_bin(
    keys: np.ndarray, n_nodes: int, lo: int, hi: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Dedup one node-range bin of packed edge keys into CSR row material.

    ``keys`` are ``u * n_nodes + v`` for every directed slot whose source
    ``u`` lies in ``[lo, hi)`` (one spill bin of the external dedup).
    ``np.unique`` sorts them — u-major, v-minor — which is exactly the order
    :meth:`Graph.from_edges` emits, so concatenating bins over ascending
    disjoint ranges yields the identical global CSR. Returns
    ``(row_counts [hi - lo], neighbor_ids int32)``.
    """
    uniq = np.unique(np.asarray(keys, dtype=np.int64))
    u = uniq // n_nodes
    counts = np.bincount(u - lo, minlength=hi - lo)
    return counts, (uniq % n_nodes).astype(np.int32)


@spanned("repro_torch.divide.induce")
def induced_subgraph(
    g: Graph,
    keep_mask: np.ndarray,
    chunk_slots: Optional[int] = None,
    stats: Optional[DivideStats] = None,
    device=None,
) -> Tuple[Graph, np.ndarray]:
    """Induced subgraph on ``keep_mask`` with relabeled ids.

    Returns ``(subgraph, node_ids)`` where ``node_ids[new_id] = old_id``.
    With ``device`` (a torch device) the pass runs there instead, in one
    piece (:func:`_induced_subgraph_on`), to the same arrays.

    Runs as two chunked passes over CSR row ranges of at most ``chunk_slots``
    adjacency slots (``None`` = :data:`DEFAULT_DIVIDE_CHUNK_SLOTS`): pass 1
    counts surviving columns per kept row, pass 2 writes the relabeled
    columns straight into the preallocated output ``indices`` array. Row
    ranges are scanned in ascending order and relabeling is monotone, so the
    output is **bit-identical at every chunk size** to a single dense pass —
    and transient host bytes are bounded by the chunk budget plus ``O(n)``
    id maps, never by the edge count. ``stats`` (a :class:`DivideStats`)
    tracks the transient peak.
    """
    keep_mask = np.asarray(keep_mask, dtype=bool)
    if keep_mask.shape != (g.n_nodes,):
        raise ValueError("mask shape mismatch")
    if device is not None:
        return _induced_subgraph_on(g, keep_mask, device, stats)
    node_ids = np.nonzero(keep_mask)[0].astype(np.int64)
    n_sub = node_ids.shape[0]
    new_id = np.full(g.n_nodes, -1, dtype=np.int64)
    new_id[node_ids] = np.arange(n_sub, dtype=np.int64)
    budget = _resolve_chunk_slots(chunk_slots)
    persistent = keep_mask.nbytes + node_ids.nbytes + new_id.nbytes

    # Pass 1: count surviving columns per kept row (chunk-bounded scratch).
    counts = np.zeros(n_sub, dtype=np.int64)
    for lo, hi, src, cols in _iter_adjacency_chunks(g, budget):
        keep_edge = keep_mask[src] & keep_mask[cols]
        cnt = np.bincount(src[keep_edge] - lo, minlength=hi - lo)
        rows_kept = keep_mask[lo:hi]
        counts[new_id[lo:hi][rows_kept]] = cnt[rows_kept]
        if stats is not None:
            stats.n_chunks += 1
            stats.input_slots += int(src.size)
            stats.kept_slots += int(keep_edge.sum())
            stats.bump(
                persistent + counts.nbytes
                + src.nbytes + keep_edge.nbytes * 2 + cnt.nbytes
            )
    indptr = np.zeros(n_sub + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    if stats is not None:
        # Dense model of the whole extraction: np.repeat source + edge mask
        # over all slots, compacted int64 pairs + int32 cast over kept.
        stats.note_pass(2 * g.n_edges, int(indptr[-1]), slot_bytes=9, kept_bytes=20)

    # Pass 2: fill the output. Kept rows appear in ascending order across
    # chunks, so each chunk's surviving columns land in one contiguous
    # region of the output stream — a running cursor suffices.
    sub_indices = np.empty(int(indptr[-1]), dtype=np.int32)
    out_pos = 0
    for lo, hi, src, cols in _iter_adjacency_chunks(g, budget):
        keep_edge = keep_mask[src] & keep_mask[cols]
        sub_dst = new_id[cols[keep_edge]]
        sub_indices[out_pos : out_pos + sub_dst.size] = sub_dst
        out_pos += int(sub_dst.size)
        if stats is not None:
            stats.bump(
                persistent + counts.nbytes
                + src.nbytes + keep_edge.nbytes * 2 + sub_dst.nbytes * 2
            )
    sub = Graph(indptr=indptr, indices=sub_indices, n_nodes=int(n_sub))
    return sub, node_ids


def _slot_rows_on(g: Graph, device):
    """``g``'s adjacency on ``device`` as int64 ``(src, cols)``: each slot's
    row and column."""
    cols = torch.from_numpy(np.ascontiguousarray(g.indices)).to(device).long()
    lens = torch.from_numpy(np.diff(g.indptr).astype(np.int64)).to(device)
    src = torch.repeat_interleave(torch.arange(g.n_nodes, device=device), lens,
                                  output_size=cols.numel())
    return src, cols


def _count_pass(stats: Optional[DivideStats], slots: int, kept: int) -> None:
    """A device pass's slots in ``stats``: one chunk, and no host bytes
    (its scratch lives on the device)."""
    if stats is not None:
        stats.n_chunks += 1
        stats.input_slots += int(slots)
        stats.kept_slots += int(kept)


def _induced_subgraph_on(g: Graph, keep_mask: np.ndarray, device,
                         stats: Optional[DivideStats]) -> Tuple[Graph, np.ndarray]:
    """:func:`induced_subgraph` as torch ops on ``device``: the slots whose
    both ends are kept, relabeled, in CSR order (a mask keeps the order, so
    the arrays are the host pass's)."""
    keep = torch.from_numpy(keep_mask).to(device)
    src, cols = _slot_rows_on(g, device)
    node_ids = torch.nonzero(keep).flatten()
    new_id = torch.full((g.n_nodes,), -1, dtype=torch.int64, device=device)
    new_id[node_ids] = torch.arange(node_ids.numel(), device=device)
    edge = keep[src] & keep[cols]
    sub_src, sub_dst = new_id[src[edge]], new_id[cols[edge]].to(torch.int32)
    del src, cols, edge
    indptr = torch.zeros(node_ids.numel() + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(sub_src, minlength=node_ids.numel()), 0, out=indptr[1:])
    _count_pass(stats, g.indices.size, sub_dst.numel())
    sub = Graph(indptr=indptr.cpu().numpy(), indices=sub_dst.cpu().numpy(),
                n_nodes=int(node_ids.numel()))
    return sub, node_ids.cpu().numpy()


@spanned("repro_torch.divide.external")
def external_info(
    g: Graph,
    keep_mask: np.ndarray,
    upper_mask: np.ndarray,
    chunk_slots: Optional[int] = None,
    stats: Optional[DivideStats] = None,
    device=None,
) -> np.ndarray:
    """E(v) = number of neighbors of ``v`` inside ``upper_mask``.

    Returned per *surviving* node (``keep_mask`` order, relabeled ids).
    ``upper_mask`` marks nodes whose coreness is already finalized at a value
    >= the part's threshold (Definition 3). One chunked pass over CSR row
    ranges (``chunk_slots`` adjacency slots of transient, ``None`` =
    :data:`DEFAULT_DIVIDE_CHUNK_SLOTS`); each range's counts land in a
    disjoint slice of the per-node accumulator, so the result is exact at
    every chunk size. With ``device`` (a torch device) the pass runs there,
    in one piece, to the same array.
    """
    keep_mask = np.asarray(keep_mask, dtype=bool)
    upper_mask = np.asarray(upper_mask, dtype=bool)
    if device is not None:
        keep = torch.from_numpy(keep_mask).to(device)
        src, cols = _slot_rows_on(g, device)
        contributes = keep[src] & torch.from_numpy(upper_mask).to(device)[cols]
        ext_full = torch.bincount(src[contributes], minlength=g.n_nodes)
        _count_pass(stats, g.indices.size, int(contributes.sum()))
        return ext_full[keep].to(torch.int32).cpu().numpy()
    ext_full = np.zeros(g.n_nodes, dtype=np.int64)
    budget = _resolve_chunk_slots(chunk_slots)
    persistent = keep_mask.nbytes + upper_mask.nbytes + ext_full.nbytes
    contributed = 0
    for lo, hi, src, cols in _iter_adjacency_chunks(g, budget):
        contributes = keep_mask[src] & upper_mask[cols]
        ext_full[lo:hi] = np.bincount(src[contributes] - lo, minlength=hi - lo)
        if stats is not None:
            stats.n_chunks += 1
            stats.input_slots += int(src.size)
            contributed += int(contributes.sum())
            stats.bump(persistent + src.nbytes + contributes.nbytes * 2)
    if stats is not None:
        stats.kept_slots += contributed
        # Dense model: np.repeat source + mask over all slots, compacted
        # int64 source ids over contributing slots.
        stats.note_pass(2 * g.n_edges, contributed, slot_bytes=9, kept_bytes=8)
    return ext_full[keep_mask].astype(np.int32)


def _tile_row_cap(n_rows: int, row_align: int, max_bucket_rows) -> int:
    """Resolve a *uniform* per-bucket row cap (the non-``"auto"`` paths).

    ``None`` disables splitting (one tile per degree class — coarsest
    frontier granularity, smallest trace); an int caps tiles at that many
    rows uniformly across all degree classes (rounded up to ``row_align``).
    The ``"auto"`` policy no longer lands here: :func:`bucketize` routes it
    through :func:`autotune_tile_caps`, which picks *per-degree-class* caps
    from the part's locality profile.
    """
    if max_bucket_rows is None:
        return n_rows if n_rows > 0 else 1
    return _align_up(int(max_bucket_rows), row_align)


def _align_up(x: int, align: int) -> int:
    return max(align, -(-int(x) // align) * align)


def autotune_tile_caps(
    g: Graph,
    row_align: int = 8,
    tile_budget: int = 48,
    min_cap: int = 128,
    locality_boost: float = 3.0,
) -> Dict[int, int]:
    """Degree-profile tile autotuner: per-degree-class row caps.

    Returns ``{bucket_width: row_cap}`` for every non-empty degree class.
    Tiles are the scheduling unit of active-frontier sweeps, so the cap is
    a work/compile-time trade-off with an asymmetry the old uniform
    ``n_rows/48`` heuristic ignored:

    * The **static** filter (bucket-adjacency bitmap) only pays off for a
      tile whose rows' neighbor ids are co-located — then the tile is
      adjacent to few other tiles and the bitmap row is sparse. Splitting a
      class whose rows reach across the whole id range (hubs, or any class
      on an unordered graph) cannot sparsify the bitmap: every shard of it
      stays adjacent to everything.
    * The **dynamic** filter (row-exact dirty bits) gets finer with smaller
      tiles regardless of locality — a tile is skipped iff none of its own
      rows has a changed neighbor.

    So the tuner splits *everywhere* (dynamic wins) but spends the tile
    budget preferentially on classes with small neighbor spans (static
    wins), measured from the actual CSR via
    :func:`~repro_torch.graph.reorder.neighbor_spans`:

    1. per class ``c``: rows ``n_c`` and mean neighbor-span fraction
       ``f_c = mean(span) / n`` (0 = perfectly local, 1 = global reach);
    2. tile share ``w_c = n_c * (1 + locality_boost * (1 - f_c))`` — a
       perfectly local class gets ``1 + locality_boost`` times the tiles of
       an equally-sized global one;
    3. ``cap_c = ceil(n_c / t_c)`` with ``t_c ∝ w_c`` summing to
       ``tile_budget``, clamped to ``>= min_cap`` and aligned to
       ``row_align``.

    ``min_cap`` bounds the total tile count on small parts (the unrolled
    sweep trace is linear in tiles); ``tile_budget`` bounds it on large
    ones. On an identity-ordered power-law graph every ``f_c ≈ 1`` and the
    allocation degenerates to the old uniform heuristic; after RCM/BFS
    reordering (:mod:`repro_torch.graph.reorder`) the low-degree long-tail
    classes — most of the rows — have small spans and receive fine tiles,
    which is what makes the static filter fire.
    """
    from repro_torch.graph.reorder import neighbor_spans

    deg = g.degrees
    n = max(g.n_nodes, 1)
    span = neighbor_spans(g)
    classes = []  # (width, n_rows, span_frac)
    for width, members in _degree_classes(deg):
        f_c = float(span[members].mean()) / n
        classes.append((width, members.size, min(f_c, 1.0)))
    if not classes:
        return {}

    weights = np.array(
        [n_c * (1.0 + locality_boost * (1.0 - f_c)) for _w, n_c, f_c in classes]
    )
    shares = weights / weights.sum() * tile_budget
    caps: Dict[int, int] = {}
    for (width, n_c, _f_c), t_c in zip(classes, shares):
        cap = -(-n_c // max(1.0, t_c))
        caps[width] = _align_up(max(cap, min_cap), row_align)
    return caps


def bucketize(
    g: Graph,
    ext: Optional[np.ndarray] = None,
    row_align: int = 8,
    max_bucket_rows="auto",
) -> BucketedGraph:
    """Convert a CSR part into degree-bucketed padded dense tiles.

    Nodes of degree 0 are excluded from every bucket: their coreness is
    exactly ``ext`` at initialization and never changes. Bucket rows are
    padded to a multiple of ``row_align`` (sublane alignment; the distributed
    engine re-pads rows to a multiple of the node-shard count).

    Each degree class is split into row-tiles; tiles are the scheduling unit
    of active-frontier sweeps, so finer tiles mean more precise skipping at
    the cost of a longer unrolled sweep trace. ``max_bucket_rows`` picks the
    policy:

    * ``"auto"`` (default) — per-degree-class caps from
      :func:`autotune_tile_caps`: the tile budget (~48 tiles) is spent
      preferentially on classes whose neighbor ids are co-located, where the
      static bucket-adjacency filter can actually fire. This is where
      locality-aware reordering (:func:`~repro_torch.graph.reorder.reorder_graph`)
      pays off.
    * an ``int`` — uniform cap of that many rows per tile for every class.
    * ``None`` — no splitting: exactly one tile per degree class (coarsest
      frontier, smallest trace; the pre-frontier layout).

    The ``bucket_adj`` bitmap over tiles is recorded for the engines.

    If ``g`` is reordered (``g.perm`` set), ``ext`` must be given in
    **original**-id order — it is permuted into the layout order here, and
    the decompose engines un-permute coreness on the way out, so reordering
    stays invisible to callers. ``perm``/``inv_perm`` are propagated onto
    the returned :class:`~repro_torch.graph.structs.BucketedGraph`.

    While a torch profiler records, the call records the span
    ``repro_torch.bucketize`` with the children ``.caps``, ``.tiles`` and
    ``.adjacency`` (:mod:`repro_torch.trace`).
    """
    with span("repro_torch.bucketize"):
        deg = g.degrees
        n = g.n_nodes
        if ext is None:
            ext = np.zeros(n, dtype=np.int32)
        ext = np.asarray(ext, dtype=np.int32)
        if ext.shape != (n,):
            raise ValueError("ext shape mismatch")
        if g.perm is not None:
            ext = ext[g.perm]  # original-id order -> layout order

        buckets = []
        # node -> bucket index (sentinel slot n and degree-0 nodes map to -1).
        node_bucket = np.full(n + 1, -1, dtype=np.int32)
        with span("repro_torch.bucketize.caps"):
            if max_bucket_rows == "auto":
                caps = autotune_tile_caps(g, row_align=row_align)
            else:
                uniform = _tile_row_cap(int((deg > 0).sum()), row_align, max_bucket_rows)
                caps = None
        with span("repro_torch.bucketize.tiles"):
            for width, members_all in _degree_classes(deg):
                row_cap = caps[width] if caps is not None else uniform
                for tile_lo in range(0, members_all.size, row_cap):
                    members = members_all[tile_lo : tile_lo + row_cap]
                    nb = _align_up(members.size, row_align)
                    # Padded rows scatter into the sentinel slot `n` of the
                    # state vector (re-pinned to -1 after each update),
                    # never into a node.
                    node_ids = np.full(nb, n, dtype=np.int32)
                    node_ids[: members.size] = members
                    neigh = np.full((nb, width), n, dtype=np.int32)  # sentinel pad
                    row_deg = np.zeros(nb, dtype=np.int32)
                    row_deg[: members.size] = deg[members]
                    # Fill rows: gather each member's adjacency slice.
                    starts = g.indptr[members]
                    lens = deg[members]
                    flat_idx = (starts[:, None] + np.arange(width)[None, :]).astype(np.int64)
                    valid = np.arange(width)[None, :] < lens[:, None]
                    flat_idx = np.where(valid, flat_idx, 0)
                    vals = g.indices[flat_idx]
                    neigh[: members.size] = np.where(valid, vals, n)
                    node_bucket[members] = len(buckets)
                    buckets.append(
                        Bucket(node_ids=node_ids, neigh=neigh, deg=row_deg, width=width)
                    )

        # Bucket-adjacency bitmap for frontier scheduling. An endpoint of any
        # edge has degree >= 1, so every real neighbor id maps to a bucket;
        # sentinel-padded slots map to -1 and are dropped. Diagonal is kept
        # set (conservative: a bucket that changed rescans itself next sweep)
        # and the matrix is symmetrized — CSR symmetry makes it symmetric
        # already, but padding asymmetries must never weaken the soundness
        # argument.
        with span("repro_torch.bucketize.adjacency"):
            nb = len(buckets)
            adj = np.zeros((nb, nb), dtype=bool)
            np.fill_diagonal(adj, True)
            for bi, b in enumerate(buckets):
                touched = np.unique(node_bucket[b.neigh.ravel()])
                adj[bi, touched[touched >= 0]] = True
            adj |= adj.T

    return BucketedGraph(
        n_nodes=n, buckets=buckets, ext=ext, degrees=deg.astype(np.int32),
        bucket_adj=adj, node_bucket=node_bucket,
        perm=g.perm, inv_perm=g.inv_perm,
    )
