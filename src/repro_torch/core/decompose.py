"""Single-device k-core decomposition engine (PyTorch).

This is the conquer step's compute engine: the h-index fixed point of paper
Algorithms 1/2 over a :class:`~repro_torch.graph.structs.BucketedGraph`
part. Estimates start at ``deg + ext`` and monotonically decrease to the
exact coreness (paper Corollary 2 / Montresor et al.).

The state vector ``c`` has ``n + 1`` entries: slot ``n`` is the ``-1``
sentinel that padded neighbor slots gather from, so padding never needs a
mask in the inner loop. Per iteration, per degree-bucket:

    gathered = c[bucket.neigh]                  # [nb, width]
    new      = hindex(gathered, ext[bucket])    # Algorithm 2
    c[bucket.node_ids] = new                    # pad rows hit slot n

Four interchangeable sweep engines (``op=``), each the port of the JAX
package's engine of the same name:

  * ``"sorted"`` -- descending sort + prefix scan (paper's literal loop).
  * ``"count"``  -- sort-free suffix counts.
  * ``"kernel"`` -- the CUDA h-index kernel (``kernels.hindex``) over the
    gathered matrix, with the degeneracy-bounded candidate window.
  * ``"fused"``  -- the fused CUDA sweep kernel (``kernels.fused``): gather
    + h-index + dirty-bit push in ONE launch per bucket, the gathered
    matrix never materialized. With few tiles each active bucket gets its
    own launch ("cond" dispatch: bit-identical trajectory to the engines
    above); past ``fused_compaction_min_tiles`` tiles the active tiles of
    each width group are compacted into one launch ("compaction": reads
    are Jacobi within the group, Gauss-Seidel across groups). The fixed
    point is unique, so final coreness stays bit-identical in every mode.

On a CPU device the kernel wrappers run their plain PyTorch versions.

``int16=True`` (fused only) keeps the resident estimate vector int16 for
half the gather bytes; an overflow guard falls back to int32 whenever any
starting estimate (``deg + ext``) reaches ``2**15`` -- estimates only
decrease, so below that bound int16 can never wrap. The result reports the
dtype actually used (``est_dtype``).

**Active-frontier sweep scheduling.** Each sweep returns a per-bucket
changed count plus a per-bucket dirty flag, and the next sweep skips every
bucket that is quiescent -- a host ``if`` on the frontier mask, the
counterpart of the reference's ``lax.cond``. Two sound filters compose:

  1. the static ``bucket_adj`` bitmap (recorded once at bucketize time):
     a bucket none of whose adjacent buckets changed cannot change;
  2. per-node dirty bits pushed on device from changed rows of active
     buckets along their adjacency: a bucket none of whose OWN rows has a
     changed neighbor cannot change.

``frontier=False`` restores always-full sweeps. The host reads the
device once per sweep (the changed counts and dirty flags together).

The *communication amount* (paper Section 5.4 metric: number of updated
estimates communicated per iteration) is counted on every step, with the
matching *work* metric of the frontier: gathered rows per sweep.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.hindex import hindex_count, hindex_of_tensor, hindex_sorted
from repro_torch.core.upload import to_device
from repro_torch.device import resolve_device
from repro_torch.graph.structs import BucketedGraph
from repro_torch.kernels.fused import fused_sweep_op
from repro_torch.kernels.hindex import hindex_op
from repro_torch.roofline.kcore_model import sweep_cost
from repro_torch.trace import span

OPS = ("sorted", "count", "kernel", "fused")


@dataclasses.dataclass
class DecomposeResult:
    """Outcome of one part decomposition.

    ``coreness`` is always reported in **original**-id order: engines
    running on a reordered layout (``BucketedGraph.perm`` set) gather
    ``coreness[inv_perm]`` before returning, so reordering never leaks.
    """

    coreness: np.ndarray  # [n_nodes] int32
    iterations: int
    comm_amount: int  # total changed estimates across iterations
    comm_per_iter: List[int]
    peak_bytes: int  # device bytes of graph tiles + state
    wall_time_s: float
    # Work metric (frontier scheduling): bucket rows gathered+h-indexed per
    # sweep, and what one always-full sweep would have gathered.
    active_rows_per_iter: List[int] = dataclasses.field(default_factory=list)
    rows_per_full_sweep: int = 0
    # Measured collective traffic of a distributed engine; empty here (a
    # single-device run issues no collectives).
    collective_bytes_per_iter: List[int] = dataclasses.field(default_factory=list)
    # Modeled HBM traffic / compare-FLOPs per live sweep
    # (roofline.kcore_model, from the active-frontier mask and the engine's
    # fused/unfused dispatch shape).
    sweep_bytes_per_iter: List[int] = dataclasses.field(default_factory=list)
    sweep_flops_per_iter: List[int] = dataclasses.field(default_factory=list)
    # Estimate dtype the sweep actually ran with ("int16" only when the
    # opt-in mode passed the overflow guard) and, for op="fused", which
    # dispatch shape ran ("cond" | "compaction").
    est_dtype: str = "int32"
    fused_mode: str = ""

    @property
    def sweep_bytes(self) -> int:
        """Total modeled sweep HBM bytes across all iterations."""
        return int(sum(self.sweep_bytes_per_iter))

    @property
    def sweep_flops(self) -> int:
        """Total modeled sweep compare-FLOPs across all iterations."""
        return int(sum(self.sweep_flops_per_iter))

    @property
    def gathered_rows(self) -> int:
        """Total rows gathered across all sweeps (the work-done counter)."""
        return int(sum(self.active_rows_per_iter))

    @property
    def full_sweep_rows(self) -> int:
        """Rows the always-full-sweep schedule would have gathered."""
        return int(self.rows_per_full_sweep * self.iterations)

    @property
    def collective_bytes(self) -> int:
        """Total measured per-device collective bytes across all sweeps."""
        return int(sum(self.collective_bytes_per_iter))


class _Tiles:
    """The buckets' tiles on the device, the one resident layout of every
    engine and both fused dispatches, plus the concatenated row ids and
    their bucket keys that the per-sweep dirty read-back gathers. Each
    bucket crosses to the device once (:func:`to_device`); the row ids and
    keys are built there from it. ``classes`` holds the compaction
    dispatch's launch groups: per width class, ascending, the class's
    buckets in bucket order as ``(bucket, first row in all_ids, rows)``."""

    def __init__(self, bg: BucketedGraph, device: torch.device):
        n = bg.n_nodes
        self.buckets = [
            (to_device(b.node_ids, torch.int32, device),
             to_device(b.neigh, torch.int32, device))
            for b in bg.buckets
        ]
        if self.buckets:
            self.all_ids = torch.cat([ids for ids, _ in self.buckets])
        else:
            self.all_ids = torch.zeros(0, dtype=torch.int32, device=device)
        self.real = self.all_ids != n
        rows = torch.tensor([b.n_rows for b in bg.buckets], dtype=torch.int64)
        # Bucket i repeated n_rows(i) times, int64 as index_add_ takes it.
        self.tile_of = torch.repeat_interleave(
            rows.to(device, non_blocking=True), output_size=int(rows.sum()))
        by_width: dict = {}
        start = 0
        for bi, b in enumerate(bg.buckets):
            by_width.setdefault(b.width, []).append((bi, start, b.n_rows))
            start += b.n_rows
        self.classes = [by_width[w] for w in sorted(by_width)]

    def dirty_next(self, dirty: torch.Tensor, track_dirty: bool) -> torch.Tensor:
        """[n_buckets] bool: does some real row of the bucket have a
        changed neighbor (its dirty bit set)? All False when the sweep
        tracked no dirty bits."""
        if not (track_dirty and self.buckets):
            return torch.zeros(len(self.buckets), dtype=torch.bool, device=dirty.device)
        flags = ((dirty[self.all_ids] > 0) & self.real).to(torch.int32)
        out = torch.zeros(len(self.buckets), dtype=torch.int32, device=dirty.device)
        return out.index_add_(0, self.tile_of, flags) > 0


def _tile_bytes(bg: BucketedGraph, fused_mode: str) -> int:
    """Resident tile bytes of the reference's memory model (its
    ``peak_bytes`` less the state): the bucketed graph for the per-bucket
    dispatches; for the compaction dispatch each width class as one
    ``[rows + 1, width]`` int32 array with its row ids and row keys (the
    reference's all-sentinel pad row included)."""
    if fused_mode != "compaction":
        return bg.memory_bytes()
    rows: dict = {}
    for b in bg.buckets:
        rows[b.width] = rows.get(b.width, 0) + b.n_rows
    return sum((r + 1) * (8 + 4 * w) for w, r in rows.items())


def _apply_op(gathered, ext_rows, op: str, cand: int):
    if op == "sorted":
        return hindex_sorted(gathered, ext_rows)
    if op == "count":
        return hindex_count(gathered, ext_rows, cand_chunk=min(256, cand))
    return hindex_op(gathered, ext_rows, cand=cand)


def _sweep(c, ext_pad, tiles: _Tiles, active: np.ndarray, *, op: str,
           cand: int, frozen_reads: bool, track_dirty: bool):
    """One sweep over the active buckets, updating ``c`` in place.

    Returns device tensors ``(changed [n_buckets], dirty_next
    [n_buckets])``: ``changed[i]`` counts rows of bucket ``i`` whose
    estimate changed (the paper's communication amount, per bucket);
    ``dirty_next[j]`` is True iff some row of bucket ``j`` has a neighbor
    that changed this sweep -- changed rows *push* a per-node dirty bit
    along their adjacency, and each bucket then reads back only its own
    rows' bits. ``active`` is the host frontier mask: inactive buckets are
    skipped outright and report 0 changed rows. ``track_dirty=False``
    (the always-full-sweep baseline) skips the push and read-back.

    ``frozen_reads=False`` is Gauss-Seidel: later buckets read estimates
    already updated this sweep. ``True`` gives textbook Jacobi. Within one
    bucket the reads are always Jacobi: the new estimates go to a separate
    tensor and are scattered into ``c`` only after the bucket's h-index.
    """
    sentinel = c.shape[0] - 1
    src = c.clone() if frozen_reads else c  # what every bucket reads
    dirty = torch.zeros(c.shape[0], dtype=torch.int8, device=c.device)
    changed = torch.zeros(len(tiles.buckets), dtype=torch.int64, device=c.device)
    for bi, (node_ids, neigh) in enumerate(tiles.buckets):
        if not active[bi]:
            continue
        if op == "fused":
            est, row_changed, _ = fused_sweep_op(
                src, ext_pad, node_ids, neigh, cand=cand,
                track_dirty=track_dirty, dirty=dirty,
            )
        else:
            gathered = src[neigh]  # sentinel slot -> -1
            cur_rows = src[node_ids]
            est = _apply_op(gathered, ext_pad[node_ids], op, cand)
            # Pad rows (node_ids == sentinel) scatter into slot n, which is
            # re-pinned below, and never count as changed.
            row_changed = (est != cur_rows) & (node_ids != sentinel)
            if track_dirty:
                # Push dirty bits to every neighbor of a changed row. Work
                # is proportional to the ACTIVE tile sizes, not the graph.
                dirty[neigh[row_changed]] = 1
        changed[bi] = row_changed.sum()
        # In place: one [n+1] state vector for the whole run instead of a
        # fresh copy per bucket update.
        c[node_ids] = est.to(c.dtype)
        c[-1] = -1  # re-pin sentinel
    return changed, tiles.dirty_next(dirty, track_dirty)


def _compaction_sweep(tiles: _Tiles, c, ext_pad, active: np.ndarray,
                      cand: int, frozen_reads: bool, track_dirty: bool):
    """One fused-engine sweep, compaction dispatch (many tiles), updating
    ``c`` in place; same return contract as :func:`_sweep`.

    One launch per width class over its active tiles' rows, concatenated
    on the device. Classes run ascending (bucketize order): Gauss-Seidel
    across classes when ``frozen_reads=False``, textbook Jacobi (reads
    frozen at sweep start) otherwise. Within one class's single launch the
    reads are always Jacobi.
    """
    src = c.clone() if frozen_reads else c  # what every class reads
    dirty = torch.zeros(c.shape[0], dtype=torch.int8, device=c.device)
    changed = torch.zeros(len(tiles.buckets), dtype=torch.int64, device=c.device)
    for cls in tiles.classes:
        sel = [(bi, start, rows) for bi, start, rows in cls if active[bi]]
        if not sel:
            continue
        ids = torch.cat([tiles.buckets[bi][0] for bi, _, _ in sel])
        neigh = torch.cat([tiles.buckets[bi][1] for bi, _, _ in sel])
        est, row_changed, _ = fused_sweep_op(
            src, ext_pad, ids, neigh, cand=cand, track_dirty=track_dirty,
            dirty=dirty,
        )
        tile_of = torch.cat([tiles.tile_of[start:start + rows] for _, start, rows in sel])
        changed.index_add_(0, tile_of, row_changed.to(torch.int64))
        c[ids] = est.to(c.dtype)
        c[-1] = -1  # re-pin sentinel
    return changed, tiles.dirty_next(dirty, track_dirty)


def decompose(
    bg: BucketedGraph,
    *,
    op: str = "sorted",
    max_iter: Optional[int] = None,
    gauss_seidel: bool = True,
    frontier: bool = True,
    init_coreness=None,
    seed_nodes: Optional[np.ndarray] = None,
    on_sweep=None,
    int16: bool = False,
    fused_compaction_min_tiles: int = 64,
    device="cuda",
) -> DecomposeResult:
    """Run the h-index fixed point on one part until no estimate changes.

    ``device`` is where the sweep runs (default ``"cuda"``; without a GPU
    that raises -- pass ``"cpu"`` to run the plain versions on the CPU).

    ``frontier`` enables active-frontier sweep scheduling (sound bucket
    skipping via the bucket-adjacency bitmap); ``False`` re-sweeps every
    bucket every iteration. ``init_coreness`` (numpy array or tensor)
    resumes from a snapshot: fixed-point iterations are restartable from
    ANY valid upper bound of the true coreness, except on the nodes with no
    neighbour in the part: they sit in no tile, no sweep visits them, and
    they are returned with their start value, so their start must already
    be exact (their ``ext``). ``on_sweep(iteration,
    coreness)`` is called after every sweep with an int32 tensor on the
    run's device, in original-id order (a copy: later sweeps do not change
    it).

    If ``bg`` was built from a reordered graph (``bg.perm`` set), the
    reordering is invisible here: ``init_coreness`` is taken in original-id
    order and permuted in, ``on_sweep`` views and the returned ``coreness``
    are permuted back.

    ``seed_nodes`` restricts the INITIAL active frontier to the buckets
    owning the given nodes (original-id boolean mask or id array) instead
    of every bucket. Requires ``frontier=True`` (the dirty-bit propagation
    is what re-activates neighbors of changed seeds).

    ``op="fused"`` dispatches the fused sweep kernel; ``int16`` (fused only)
    opts into the halved-width estimate vector behind the overflow guard,
    and ``fused_compaction_min_tiles`` sets the tile count at which the
    per-bucket dispatch is replaced by the active-row compaction. Snapshot
    traffic (``init_coreness`` in, ``on_sweep`` views and ``coreness`` out)
    is int32 regardless.

    While a torch profiler records, the call records the spans of
    :mod:`repro_torch.trace`: ``repro_torch.decompose`` around it, with
    the children ``.start`` (``ext`` and the degrees uploaded and added
    into ``deg + ext``, a snapshot uploaded), ``.guard`` (the largest
    start value, on the device), ``.cand`` (``deg + ext``'s h-index on the
    device by :func:`~repro_torch.core.hindex.hindex_of_tensor`, and the
    set-up's one read, which brings both values to the host), ``.tiles``
    and ``.result``, and one ``repro_torch.sweep`` a sweep, with the children
    ``.launch`` (every launch enqueued) and ``.wait`` (the sweep's one read).
    """
    dev = resolve_device(device)
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    n = bg.n_nodes
    t0 = time.perf_counter()
    with span("repro_torch.decompose"):
        if int16 and op != "fused":
            raise ValueError("int16=True requires op='fused' (the fused "
                             "kernel widens in-register; the unfused "
                             "engines assume int32 state)")
        with span("repro_torch.decompose.start"):
            ext_pad = torch.cat([
                torch.as_tensor(np.asarray(bg.ext), dtype=torch.int32).to(dev),
                torch.zeros(1, dtype=torch.int32, device=dev)])
            # deg + ext: the start state, and what the guard and the
            # candidate window are defined on, with a snapshot or without.
            deg_ext = (torch.as_tensor(bg.degrees, dtype=torch.int32).to(dev)
                       + ext_pad[:n])
            if init_coreness is not None:
                if isinstance(init_coreness, torch.Tensor):
                    start = init_coreness.to(dev)
                else:  # np.array copies: the snapshot may be a read-only buffer
                    start = torch.from_numpy(np.array(init_coreness)).to(dev)
                if bg.perm is not None:
                    # original-id order -> layout order
                    start = start[torch.as_tensor(bg.perm).to(dev)]
            else:
                start = deg_ext
        with span("repro_torch.decompose.guard"):
            # Overflow guard: estimates start at deg + ext and only
            # decrease, so int16 is exact iff every start fits. Fall back,
            # never wrap.
            max_start = deg_ext.amax() if int16 and n else deg_ext.new_zeros(())
        with span("repro_torch.decompose.cand"):
            # Candidate-window bound (exact; see hindex_of_sequence
            # docstring), read back with the guard's value in one read.
            max_start, h = torch.stack(
                [max_start.to(torch.int64), hindex_of_tensor(deg_ext)]).cpu().tolist()
            cand = max(1, h)
        est_dtype = torch.int16 if int16 and max_start < (1 << 15) else torch.int32
        c = torch.cat([start.to(est_dtype),
                       torch.full((1,), -1, dtype=est_dtype, device=dev)])
        del deg_ext, start  # off the card before the tiles go up

        fused_mode = ""
        if op == "fused":
            fused_mode = (
                "compaction" if len(bg.buckets) >= fused_compaction_min_tiles
                else "cond"
            )
        with span("repro_torch.decompose.tiles"):
            tiles = _Tiles(bg, dev)

        wire = 2 if est_dtype == torch.int16 else 4
        state_bytes = int(c.numel() * wire + ext_pad.numel() * 4)
        peak = _tile_bytes(bg, fused_mode) + state_bytes

        n_buckets = len(bg.buckets)
        bucket_rows = np.array([b.n_rows for b in bg.buckets], dtype=np.int64)
        bucket_widths = list(bg.widths)
        adj = bg.bucket_adjacency()
        active = np.ones(n_buckets, dtype=bool)
        if seed_nodes is not None:
            if not frontier:
                raise ValueError("seed_nodes requires frontier=True (seed "
                                 "restriction relies on dirty-bit scheduling "
                                 "to re-activate neighbors)")
            seeds = np.asarray(seed_nodes)
            if seeds.dtype == bool:
                if seeds.shape != (n,):
                    raise ValueError(f"seed mask shape {seeds.shape} != ({n},)")
                seeds = np.nonzero(seeds)[0]
            if bg.inv_perm is not None:
                # Seeds arrive as original ids; the owner map is in layout
                # order, and original id o sits at layout row inv_perm[o].
                seeds = np.asarray(bg.inv_perm)[seeds]
            owner = bg.node_bucket_map()[:-1][seeds]
            active = np.zeros(n_buckets, dtype=bool)
            active[owner[owner >= 0]] = True  # -1: deg-0 rows own no bucket

        limit = max_iter if max_iter is not None else max(4, n)
        # Uploaded once: the on_sweep view is permuted back every sweep.
        inv_perm_dev = (
            torch.as_tensor(bg.inv_perm).to(dev)
            if on_sweep is not None and bg.inv_perm is not None else None
        )
        comm_per_iter: List[int] = []
        active_rows_per_iter: List[int] = []
        sweep_bytes_per_iter: List[int] = []
        sweep_flops_per_iter: List[int] = []
        total = 0
        it = 0
        while it < limit:
            with span("repro_torch.sweep"):
                active_rows_per_iter.append(int(bucket_rows[active].sum()))
                # Modeled HBM traffic / FLOPs of this sweep's live shape
                # (int16 halves the wire terms).
                mb, mf = sweep_cost(
                    [(int(bucket_rows[bi]), bucket_widths[bi])
                     for bi in np.nonzero(active)[0]],
                    cand, wire_bytes=wire, fused=(op == "fused"),
                    track_dirty=frontier,
                )
                sweep_bytes_per_iter.append(mb)
                sweep_flops_per_iter.append(mf)
                with span("repro_torch.sweep.launch"):
                    if fused_mode == "compaction":
                        changed_vec, dirty_next = _compaction_sweep(
                            tiles, c, ext_pad, active, cand,
                            frozen_reads=not gauss_seidel, track_dirty=frontier,
                        )
                    else:
                        changed_vec, dirty_next = _sweep(
                            c, ext_pad, tiles, active, op=op, cand=cand,
                            frozen_reads=not gauss_seidel, track_dirty=frontier,
                        )
                with span("repro_torch.sweep.wait"):
                    # The sweep's one host synchronisation: changed counts
                    # and dirty flags come back together.
                    host = torch.cat([changed_vec, dirty_next.to(torch.int64)]).cpu().numpy()
                changed_vec, dirty_next = host[:n_buckets], host[n_buckets:] > 0
                changed = int(changed_vec.sum())
                comm_per_iter.append(changed)
                total += changed
                it += 1
                if on_sweep is not None:
                    # Contract: int32 values in original-id order, on the device.
                    if inv_perm_dev is not None:
                        view = c[:-1][inv_perm_dev].to(torch.int32)
                    else:
                        view = c[:-1].to(torch.int32, copy=True)
                    on_sweep(it, view)
                if changed == 0:
                    break
                if frontier:
                    # Next frontier: buckets with a dirty row (a neighbor
                    # changed), intersected with the static bucket-adjacency
                    # certificate -- dirty bits refine the bitmap, never
                    # widen it.
                    reach = adj[changed_vec > 0].any(axis=0)
                    active = dirty_next & reach
        with span("repro_torch.decompose.result"):
            coreness = c[:-1].cpu().numpy().astype(np.int32, copy=False)
            if bg.inv_perm is not None:
                coreness = coreness[bg.inv_perm]  # layout order -> original-id order
    return DecomposeResult(
        coreness=coreness,
        iterations=it,
        comm_amount=total,
        comm_per_iter=comm_per_iter,
        peak_bytes=int(peak),
        wall_time_s=time.perf_counter() - t0,
        active_rows_per_iter=active_rows_per_iter,
        rows_per_full_sweep=bg.rows_per_full_sweep,
        sweep_bytes_per_iter=sweep_bytes_per_iter,
        sweep_flops_per_iter=sweep_flops_per_iter,
        est_dtype="int16" if est_dtype == torch.int16 else "int32",
        fused_mode=fused_mode,
    )
