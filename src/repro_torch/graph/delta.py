"""CSR delta application — edge churn without a full rebuild.

``apply_edge_deltas`` applies one batch of edge inserts/deletes to a
:class:`~repro_torch.graph.structs.Graph` by rebuilding ONLY the CSR rows of the
edit endpoints; every untouched row is block-copied. The edited rows go
through the same canonicalization the builders use
(:func:`~repro_torch.graph.build.canonical_slots` symmetrize-and-drop-loops,
``np.unique``-sorted packed keys), so the output is **bit-identical** to
:meth:`Graph.from_edges` on the post-edit edge set — the invariant the
incremental maintenance engine (:mod:`repro_torch.core.incremental`) and its
differential tests rest on.

Batch semantics are set-like: the new edge set is ``(E \\ deletes) ∪
inserts`` (an edge both deleted and inserted in one batch survives).
Deleting an absent edge and inserting a present one are no-ops; the
*effective* edits — the edges that actually flipped — are reported
separately because the dirty-region bounds of the incremental engine are
only as tight as the effective batch size ``b``.

Inserts may reference node ids beyond ``n_nodes``; the graph grows (new
trailing rows), mirroring a social graph gaining users. Deletes never grow
the id space.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graph.build import canonical_slots
from repro_torch.graph.structs import Graph


@dataclasses.dataclass(frozen=True)
class EdgeEdits:
    """One batch of raw edge edits (directed/duplicated input is fine).

    Arrays are int64; self-loops and duplicates are tolerated and
    canonicalized away at apply time, exactly like builder input.
    """

    ins_src: np.ndarray
    ins_dst: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray

    @staticmethod
    def of(ins_src=(), ins_dst=(), del_src=(), del_dst=()) -> "EdgeEdits":
        return EdgeEdits(
            ins_src=np.asarray(ins_src, dtype=np.int64),
            ins_dst=np.asarray(ins_dst, dtype=np.int64),
            del_src=np.asarray(del_src, dtype=np.int64),
            del_dst=np.asarray(del_dst, dtype=np.int64),
        )

    @staticmethod
    def inserts(src, dst) -> "EdgeEdits":
        return EdgeEdits.of(ins_src=src, ins_dst=dst)

    @staticmethod
    def deletes(src, dst) -> "EdgeEdits":
        return EdgeEdits.of(del_src=src, del_dst=dst)

    @property
    def n_raw(self) -> int:
        return int(self.ins_src.size + self.del_src.size)

    def concat(self, other: "EdgeEdits") -> "EdgeEdits":
        return EdgeEdits(
            ins_src=np.concatenate([self.ins_src, other.ins_src]),
            ins_dst=np.concatenate([self.ins_dst, other.ins_dst]),
            del_src=np.concatenate([self.del_src, other.del_src]),
            del_dst=np.concatenate([self.del_dst, other.del_dst]),
        )


@dataclasses.dataclass(frozen=True)
class DeltaResult:
    """Outcome of one delta application.

    ``ins_u``/``ins_v`` and ``del_u``/``del_v`` hold the EFFECTIVE
    undirected edits (``u < v``, deduplicated, no-ops removed): exactly the
    edges present in the new graph but not the old, and vice versa.
    ``rows_rebuilt`` counts CSR rows rewritten (the edit endpoints).
    """

    graph: Graph
    ins_u: np.ndarray
    ins_v: np.ndarray
    del_u: np.ndarray
    del_v: np.ndarray
    rows_rebuilt: int

    @property
    def n_inserted(self) -> int:
        return int(self.ins_u.size)

    @property
    def n_deleted(self) -> int:
        return int(self.del_u.size)

    @property
    def n_effective(self) -> int:
        return self.n_inserted + self.n_deleted


def _row_slot_indices(indptr: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Concatenated CSR slot indices of ``rows`` (ascending row order)."""
    counts = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    keep = counts > 0
    rows, counts = rows[keep], counts[keep]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    step = np.ones(total, dtype=np.int64)
    starts = indptr[rows].astype(np.int64)
    ends = np.cumsum(counts)
    step[0] = starts[0]
    step[ends[:-1]] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    return np.cumsum(step)


def apply_edge_deltas(
    g: Graph, edits: EdgeEdits, n_nodes: Optional[int] = None
) -> DeltaResult:
    """Apply one edit batch; returns the new graph + effective edits.

    Only the rows of edit endpoints are rebuilt (sorted-unique neighbor
    order, same as :meth:`Graph.from_edges`); all other rows are copied as
    contiguous blocks. ``n_nodes`` forces the output node count (must cover
    every insert endpoint); by default the graph grows to the max raw
    insert endpoint, ``from_edges``-style.
    """
    if g.perm is not None:
        raise ValueError(
            "apply_edge_deltas operates on original-id CSRs; reorder after "
            "applying deltas, not before"
        )
    ins_max = int(max(
        edits.ins_src.max(initial=-1), edits.ins_dst.max(initial=-1)
    ))
    n_new = max(g.n_nodes, ins_max + 1)
    if n_nodes is not None:
        if n_nodes < n_new:
            raise ValueError(f"n_nodes={n_nodes} < required {n_new}")
        n_new = int(n_nodes)

    iu, iv = canonical_slots(edits.ins_src, edits.ins_dst)
    du, dv = canonical_slots(edits.del_src, edits.del_dst)
    if du.size and int(max(du.max(), dv.max())) >= g.n_nodes:
        # Deleting an edge at an unknown id is a no-op by set semantics.
        keep = (du < g.n_nodes) & (dv < g.n_nodes)
        du, dv = du[keep], dv[keep]
    stride = np.int64(n_new)
    ins_keys = np.unique(iu * stride + iv)
    del_keys = np.unique(du * stride + dv)

    # Grow trailing rows first so affected-row logic sees one id space.
    indptr = g.indptr
    if n_new > g.n_nodes:
        indptr = np.concatenate([
            indptr,
            np.full(n_new - g.n_nodes, indptr[-1], dtype=np.int64),
        ])

    aff = np.unique(np.concatenate([ins_keys // stride, del_keys // stride]))
    if aff.size == 0:
        empty = np.empty(0, dtype=np.int64)
        return DeltaResult(
            graph=Graph(indptr=indptr, indices=g.indices, n_nodes=n_new),
            ins_u=empty, ins_v=empty, del_u=empty, del_v=empty,
            rows_rebuilt=0,
        )

    slots = _row_slot_indices(indptr, aff)
    counts_old = (indptr[aff + 1] - indptr[aff]).astype(np.int64)
    old_keys = (
        np.repeat(aff, counts_old) * stride
        + g.indices[slots].astype(np.int64)
    )
    # Set semantics: (E \ deletes) ∪ inserts. union1d/setdiff1d sort their
    # output, so final keys land u-major v-minor — from_edges order.
    final = np.union1d(np.setdiff1d(old_keys, del_keys), ins_keys)
    eff_ins = ins_keys[~np.isin(ins_keys, old_keys)]
    eff_del = np.setdiff1d(np.intersect1d(del_keys, old_keys), ins_keys)

    # Splice: new counts for affected rows, block-copy everything else.
    deg = np.diff(indptr)
    new_counts = deg.copy()
    new_counts[aff] = np.bincount(
        np.searchsorted(aff, final // stride), minlength=aff.size
    )
    new_indptr = np.zeros(n_new + 1, dtype=np.int64)
    np.cumsum(new_counts, out=new_indptr[1:])
    new_indices = np.empty(int(new_indptr[-1]), dtype=np.int32)
    final_vals = (final % stride).astype(np.int32)

    fin_pos = 0
    prev = 0  # first row of the next untouched block
    for i, r in enumerate(aff.tolist()):
        if prev < r:  # untouched rows [prev, r) — one contiguous block
            new_indices[new_indptr[prev]:new_indptr[r]] = (
                g.indices[indptr[prev]:indptr[r]]
            )
        cnt = int(new_counts[r])
        new_indices[new_indptr[r]:new_indptr[r] + cnt] = (
            final_vals[fin_pos:fin_pos + cnt]
        )
        fin_pos += cnt
        prev = r + 1
    if prev < n_new:
        new_indices[new_indptr[prev]:] = g.indices[indptr[prev]:]

    half = eff_ins[(eff_ins // stride) < (eff_ins % stride)]
    dhalf = eff_del[(eff_del // stride) < (eff_del % stride)]
    return DeltaResult(
        graph=Graph(indptr=new_indptr, indices=new_indices, n_nodes=n_new),
        ins_u=half // stride, ins_v=half % stride,
        del_u=dhalf // stride, del_v=dhalf % stride,
        rows_rebuilt=int(aff.size),
    )
