"""Distributed conquer engine: the h-index fixed point over the ranks of a
``torch.distributed`` process group.

The port of ``repro.core.distributed`` (a ``shard_map`` over a TPU mesh).
It maps the paper's parameter-server loop (Section 4.3.2, Figure 6) onto
the ranks of a :class:`MeshPlan` in the same way:

  paper step                      | here
  --------------------------------+----------------------------------------
  (1) vertex-centric data loading | bucket rows block-split over the node
                                  | axes; neighbour slots split over the
                                  | slot ("model") axes
  (2) pull coreness from PS       | local gather from the replicated part
                                  | coreness vector
  (3) estimate coreness (Alg 2)   | partial suffix counts per slot shard
                                  | (``kernels.counts``), ``all_reduce``
                                  | over the slot group, feasibility argmax
  (4) push updated coreness       | ``all_gather`` of the per-shard
                                  | estimates over the node group
  (5) PS in-place update          | scatter into the replicated vector

Every rank holds the whole ``[n + 1]`` estimate vector, the external
information and the node -> bucket map, and only its own row block and
slot block of each bucket. Every decision of the host loop (the frontier
mask, the ``changed == 0`` stop, the iteration limit) is taken from values
the collectives replicate, so every rank takes the same branch and issues
the same collectives. A plan of one rank issues no collective.

Collective traffic is counted from shapes as in the JAX package (ring
all-reduce and all-gather terms; :func:`measured_sweep_bytes`), from the
GLOBAL padded bucket shapes, so the counters and ``peak_bytes`` are the
reference's whatever the rank holds.

Two rules of the collective layer:

* int16 estimates travel as a ``uint8`` view (neither gloo nor NCCL
  reduces or gathers int16); the bytes on the wire are the same;
* with the gloo backend, CUDA tensors are copied to the host for the
  collective and back (decided by the backend, up front).
"""
from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.decompose import DecomposeResult
from repro_torch.core.hindex import hindex_of_sequence
from repro_torch.device import resolve_device
from repro_torch.graph.structs import BucketedGraph
from repro_torch.kernels.counts import partial_counts_op

WIRE_DTYPES = (torch.int32, torch.int16)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How the graph maps onto the ranks: a mesh of ``shape`` with named
    axes, bucket rows split over ``node_axes`` and neighbour slots over
    ``slot_axes``.

    ``ranks`` are the process group's ranks the mesh holds, in row-major
    mesh order (``0 .. size-1`` for a whole group; a block of them for a
    slice of a larger mesh, see
    :func:`repro_torch.core.partsched.slice_mesh_plans`). ``rank`` is this
    process's position in ``ranks`` and ``node_index`` / ``slot_index`` its
    row and slot blocks (row-major over the node and slot axes); all three
    are -1 on a plan that does not hold this process. ``node_group`` holds
    the ranks that share this rank's slot block, ``slot_group`` those that
    share its row block, ``world_group`` every rank of the mesh; each is
    ``None`` when it would hold one rank (or not this one). ``backend`` is
    the groups' ``torch.distributed`` backend (empty for a one-rank plan).
    :func:`repro_torch.launch.mesh.make_mesh_plan` builds one from an
    initialized process group; a one-rank plan needs none.
    """

    shape: Tuple[int, ...] = (1, 1)
    axis_names: Tuple[str, ...] = ("data", "model")
    node_axes: Tuple[str, ...] = ("data",)
    slot_axes: Tuple[str, ...] = ("model",)
    rank: int = 0
    node_index: int = 0
    slot_index: int = 0
    node_group: Any = None
    slot_group: Any = None
    world_group: Any = None
    backend: str = ""
    ranks: Tuple[int, ...] = (0,)

    def _axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    @property
    def n_node_shards(self) -> int:
        return math.prod(self._axis_size(a) for a in self.node_axes)

    @property
    def n_slot_shards(self) -> int:
        return math.prod(self._axis_size(a) for a in self.slot_axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


# ---------------------------------------------------------------------- #
# Collectives
# ---------------------------------------------------------------------- #
def _staged(plan: MeshPlan, t: torch.Tensor) -> bool:
    """gloo collectives run on host copies of CUDA tensors."""
    return plan.backend == "gloo" and t.is_cuda


def _all_reduce(plan: MeshPlan, t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (int32 / int64 only)."""
    import torch.distributed as dist

    if _staged(plan, t):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _all_gather(plan: MeshPlan, t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Concatenate every rank's 1-D ``t`` over ``group`` (``n`` ranks), in
    group-rank order."""
    import torch.distributed as dist

    if t.dtype == torch.int16:
        return _all_gather(plan, t.view(torch.uint8), group, n).view(torch.int16)
    src = t.cpu() if _staged(plan, t) else t.contiguous()
    out = torch.empty(n * src.shape[0], dtype=src.dtype, device=src.device)
    dist.all_gather(list(out.chunk(n)), src, group=group)  # into views of out
    return out.to(t.device)


# ---------------------------------------------------------------------- #
# Layout and shape math
# ---------------------------------------------------------------------- #
def _pad_to(x: np.ndarray, mult: int, axis: int, fill) -> np.ndarray:
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


class ShardedBucket(NamedTuple):
    """This rank's block of one bucket, with the bucket's global padded
    shape (``rows`` a multiple of the node shards, ``width`` of the slot
    shards)."""

    ids: torch.Tensor    # [rows / ns] int32 node ids (sentinel n pads)
    neigh: torch.Tensor  # [rows / ns, width / ms] int32 neighbour ids
    rows: int
    width: int


def shard_buckets(bg: BucketedGraph, plan: MeshPlan, device) -> List[ShardedBucket]:
    """Pad every bucket with the sentinel ``n`` (rows to the node shards,
    slots to the slot shards) and put this rank's blocks on ``device``."""
    ns, ms = plan.n_node_shards, plan.n_slot_shards
    out = []
    for b in bg.buckets:
        ids = _pad_to(np.asarray(b.node_ids), ns, 0, bg.n_nodes)
        neigh = _pad_to(_pad_to(np.asarray(b.neigh), ns, 0, bg.n_nodes), ms, 1, bg.n_nodes)
        rows, width = neigh.shape
        r0, s0 = plan.node_index * (rows // ns), plan.slot_index * (width // ms)
        out.append(ShardedBucket(
            ids=torch.from_numpy(np.ascontiguousarray(
                ids[r0 : r0 + rows // ns], dtype=np.int32)).to(device),
            neigh=torch.from_numpy(np.ascontiguousarray(
                neigh[r0 : r0 + rows // ns, s0 : s0 + width // ms], dtype=np.int32)).to(device),
            rows=rows, width=width,
        ))
    return out


def _ring_bucket_bytes(padded_rows: int, ns: int, ms: int, cand: int,
                       wire_bytes: int, include_ids: bool) -> int:
    """Per-rank bytes of ONE bucket's sweep collectives (ring model): the
    ``[rows_loc, cand]`` int32 count all-reduce over the slot shards
    (``2 (m-1)/m`` of the operand) and the ``[rows_loc]`` estimate
    all-gather over the node shards (``(n-1)`` local shards, ``wire_bytes``
    wide, plus the int32 ids all-gather when ``include_ids``).
    ``padded_rows`` is the node-shard-padded row count."""
    rows_loc = padded_rows // ns
    total = 0
    if ms > 1:
        total += int(2 * (ms - 1) / ms * rows_loc * cand * 4)
    if ns > 1:
        total += int((ns - 1) * rows_loc * (wire_bytes + (4 if include_ids else 0)))
    return total


def _dirty_psum_bytes(n_buckets: int, mesh_size: int) -> int:
    """Per-rank bytes of the frontier's [n_buckets] dirty-bit all-reduce."""
    if mesh_size <= 1:
        return 0
    return int(2 * (mesh_size - 1) / mesh_size * n_buckets * 4)


def sweep_collective_bytes(bg: BucketedGraph, plan, cand: int,
                           wire_bytes: int = 4,
                           active: Optional[np.ndarray] = None) -> int:
    """Analytic per-rank bytes of one sweep (ring model): the count
    all-reduce and the estimate all-gather of every *active* bucket. The
    planning model: it works from ``bg`` alone and leaves out the ids
    all-gather and the dirty-bit all-reduce, which
    :func:`measured_sweep_bytes` counts. ``plan`` needs only
    ``n_node_shards`` and ``n_slot_shards``."""
    ns, ms = plan.n_node_shards, plan.n_slot_shards
    total = 0
    for bi, b in enumerate(bg.buckets):
        if active is not None and not active[bi]:
            continue
        rows = math.ceil(b.n_rows / ns) * ns
        total += _ring_bucket_bytes(rows, ns, ms, cand, wire_bytes,
                                    include_ids=False)
    return total


def measured_sweep_bytes(padded_rows: Sequence[int], plan, cand: int,
                         wire_bytes: int, active: np.ndarray,
                         frontier: bool) -> int:
    """Per-rank bytes one sweep moves, from the live frontier mask and the
    buckets' GLOBAL node-shard-padded row counts: every active bucket's
    count all-reduce, estimate all-gather and int32 ids all-gather, plus
    the dirty-bit all-reduce when ``frontier`` (it runs every sweep, active
    or not). The counter :func:`decompose_distributed` records into
    ``DecomposeResult.collective_bytes_per_iter``."""
    ns, ms = plan.n_node_shards, plan.n_slot_shards
    total = 0
    for bi, rows in enumerate(padded_rows):
        if not active[bi]:
            continue
        total += _ring_bucket_bytes(int(rows), ns, ms, cand, wire_bytes,
                                    include_ids=True)
    if frontier:
        total += _dirty_psum_bytes(len(padded_rows), ns * ms)
    return total


def planned_collective_schedule(
    bucket_rows: Sequence[int],
    plan,
    cand: int,
    *,
    wire_bytes: int = 4,
    n_iters: int = 30,
    full_sweeps: int = 3,
    decay: float = 0.6,
    frontier: bool = True,
) -> List[int]:
    """Modeled per-iteration collective bytes of a run that never sweeps:
    :func:`planned_live_sets` priced with the measured counter's per-bucket
    formula. On a ``frontier=False`` run (every sweep full) it equals
    ``DecomposeResult.collective_bytes_per_iter`` byte for byte.
    ``bucket_rows`` are the UNpadded per-bucket row counts."""
    ns, ms = plan.n_node_shards, plan.n_slot_shards
    nb = len(bucket_rows)
    padded = [math.ceil(r / ns) * ns for r in bucket_rows]
    dirty = _dirty_psum_bytes(nb, ns * ms) if frontier else 0
    return [
        sum(_ring_bucket_bytes(padded[bi], ns, ms, cand, wire_bytes,
                               include_ids=True) for bi in live)
        + dirty
        for live in planned_live_sets(padded, n_iters=n_iters,
                                      full_sweeps=full_sweeps, decay=decay,
                                      frontier=frontier)
    ]


def planned_live_sets(
    padded_rows: Sequence[int],
    *,
    n_iters: int = 30,
    full_sweeps: int = 3,
    decay: float = 0.6,
    frontier: bool = True,
) -> List[List[int]]:
    """The planned frontier schedule: live bucket indices per sweep. The
    first ``full_sweeps`` iterations keep every bucket live; afterwards the
    live row budget decays geometrically by ``decay`` and is filled from
    the LAST buckets downward (the densest degree classes converge last on
    power-law graphs)."""
    nb = len(padded_rows)
    total_rows = sum(padded_rows) or 1
    out: List[List[int]] = []
    for it in range(n_iters):
        if not frontier or it < full_sweeps:
            live = list(range(nb))
        else:
            budget = total_rows * (decay ** (it - full_sweeps + 1))
            live, acc = [], 0
            for bi in range(nb - 1, -1, -1):  # densest classes stay live
                live.append(bi)
                acc += padded_rows[bi]
                if acc >= budget:
                    break
        out.append(live)
    return out


def node_tile_map(bg: BucketedGraph) -> np.ndarray:
    """[n + 1] node -> owning bucket; sentinel/deg-0 -> n_buckets (int16
    whenever the bucket count allows)."""
    nb = len(bg.buckets)
    dtype = np.int16 if nb < np.iinfo(np.int16).max else np.int32
    m = bg.node_bucket_map()
    return np.where(m < 0, nb, m).astype(dtype)


# ---------------------------------------------------------------------- #
# The sweep
# ---------------------------------------------------------------------- #
def _partial_counts(gathered: torch.Tensor, ext_rows: torch.Tensor, cand: int,
                    cand_chunk: int = 256) -> torch.Tensor:
    """Suffix counts over the LOCAL slot shard, ``cnt[r, i]`` for candidates
    ``i + 1`` in ``[1, cand]`` -- the engine's path without the kernel."""
    chunks = []
    for lo in range(0, cand, cand_chunk):
        i = torch.arange(lo + 1, min(cand, lo + cand_chunk) + 1,
                         dtype=torch.int32, device=gathered.device)
        thr = ext_rows[:, None] + i[None, :]
        chunks.append((gathered[:, :, None] >= thr[:, None, :]).sum(dim=1, dtype=torch.int32))
    return torch.cat(chunks, dim=1)


def _push_dirty(tile_dirty: torch.Tensor, node_tile: torch.Tensor, neigh: torch.Tensor,
                row_changed: torch.Tensor) -> torch.Tensor:
    """``tile_dirty`` [nb + 1] with the buckets of the changed rows'
    neighbour slots set: the reference's max-scatter of the broadcast
    changed bit over ``node_tile[neigh]``, staged per row (each row scatters
    into its own row of a [rows, nb + 1] table, then one amax over the
    rows). It indexes with no boolean mask, so it needs no device-to-host
    sync and runs on meta tensors; a flat scatter over every slot would
    serialize on the nb + 1 targets' atomics."""
    hit = torch.zeros(neigh.shape[0], tile_dirty.shape[0], dtype=torch.int32,
                      device=tile_dirty.device)
    hit.scatter_reduce_(1, node_tile[neigh].long(),
                        row_changed[:, None].expand_as(neigh).to(torch.int32), reduce="amax")
    return torch.maximum(tile_dirty, hit.amax(dim=0))


def make_sweep_fn(plan: MeshPlan, cand: int, use_kernel: bool = False,
                  frontier: bool = True):
    """The sweep of one rank: ``sweep(c, ext_pad, active, node_tile,
    buckets) -> (changed, dirty_next)``, updating the replicated estimate
    vector ``c`` in place.

    ``active`` is the host [n_buckets] frontier mask (the same on every
    rank): an inactive bucket skips its gather, counts and collectives.
    ``changed[i]`` counts rows of bucket ``i`` whose estimate changed;
    ``dirty_next[j]`` is True iff some changed row has a neighbour in
    bucket ``j`` -- each rank pushes the bits of its own slots and one
    [n_buckets] all-reduce unions them. ``frontier=False`` skips the push
    and its all-reduce. ``use_kernel=True`` computes the partial counts
    with the CUDA kernel (``kernels.counts``)."""
    ns, ms = plan.n_node_shards, plan.n_slot_shards
    counts = (partial(partial_counts_op, cand=cand) if use_kernel
              else partial(_partial_counts, cand=cand))

    def sweep(c, ext_pad, active, node_tile, buckets: List[ShardedBucket]):
        nb = len(buckets)
        sentinel = c.shape[0] - 1
        dev = c.device
        i = torch.arange(1, cand + 1, dtype=torch.int32, device=dev)
        # Slot nb is the dump row of sentinel-padded neighbours.
        tile_dirty = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
        changed = torch.zeros(nb, dtype=torch.int64, device=dev)
        for bi, b in enumerate(buckets):
            if not active[bi]:
                continue
            gathered = c[b.neigh].to(torch.int32)  # the wire may be int16
            ext_rows = ext_pad[b.ids]
            cnt = counts(gathered, ext_rows)
            if ms > 1:
                _all_reduce(plan, cnt, plan.slot_group)
            est = ext_rows + torch.where(cnt >= i, i, 0).amax(dim=1)
            est = est.to(c.dtype)
            if frontier:
                row_changed = (est != c[b.ids]) & (b.ids != sentinel)
                tile_dirty = _push_dirty(tile_dirty, node_tile, b.neigh, row_changed)
            if ns > 1:
                est_full = _all_gather(plan, est, plan.node_group, ns)
                ids_full = _all_gather(plan, b.ids, plan.node_group, ns)
            else:
                est_full, ids_full = est, b.ids
            changed[bi] = ((est_full != c[ids_full]) & (ids_full != sentinel)).sum()
            # Only sentinel pads repeat in ids_full, and their slot is
            # re-pinned straight after, so the scatter's order is moot.
            c[ids_full] = est_full
            c[-1] = -1
        dirty_next = tile_dirty[:nb]
        if frontier and plan.size > 1:
            _all_reduce(plan, dirty_next, plan.world_group)
        return changed, dirty_next > 0

    return sweep


def decompose_distributed(
    bg: BucketedGraph,
    plan: MeshPlan,
    *,
    wire_dtype=torch.int32,
    use_kernel: bool = False,
    frontier: bool = True,
    max_iter: Optional[int] = None,
    init_coreness=None,
    on_sweep=None,
    device="cuda",
) -> DecomposeResult:
    """Distributed fixed point on this rank's blocks of ``bg``; same
    contract as :func:`repro_torch.core.decompose.decompose` (``frontier``,
    ``init_coreness`` warm restart and the ``on_sweep(iteration,
    coreness)`` hook, both in **original**-id order int32; with an int16
    wire, snapshots widen to int32 on the way out and narrow on the way
    in). Every rank of ``plan`` must call it with the same arguments; each
    returns the same result.

    ``wire_dtype`` (``torch.int32`` or ``torch.int16``) is the estimate
    vector's type; ``use_kernel`` selects the CUDA partial-counts kernel;
    ``device`` is where this rank sweeps (default ``"cuda"``; without a GPU
    that raises -- pass ``"cpu"`` to run on the CPU)."""
    dev = resolve_device(device)
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype {wire_dtype} must be one of {WIRE_DTYPES}")
    n = bg.n_nodes
    t0 = time.perf_counter()
    cand = max(1, hindex_of_sequence(bg.degrees.astype(np.int64) + bg.ext))

    ext = torch.as_tensor(np.asarray(bg.ext), dtype=torch.int32).to(dev)
    ext_pad = torch.cat([ext, torch.zeros(1, dtype=torch.int32, device=dev)])
    if init_coreness is not None:
        if isinstance(init_coreness, torch.Tensor):
            start = init_coreness.to(dev)
        else:  # np.array copies: the snapshot may be a read-only buffer
            start = torch.from_numpy(np.array(init_coreness)).to(dev)
        if bg.perm is not None:
            start = start[torch.as_tensor(bg.perm).to(dev)]  # original -> layout order
        start = start.to(torch.int32).to(wire_dtype)
    else:
        start = (torch.as_tensor(bg.degrees, dtype=torch.int32).to(dev) + ext).to(wire_dtype)
    c = torch.cat([start, torch.full((1,), -1, dtype=wire_dtype, device=dev)])
    node_tile = torch.from_numpy(node_tile_map(bg)).to(dev)
    buckets = shard_buckets(bg, plan, dev)
    sweep = make_sweep_fn(plan, cand, use_kernel, frontier)

    # Peak per-rank bytes: this rank's share of the padded tiles plus the
    # replicated state (estimates, ext, the node -> bucket map).
    ns, ms = plan.n_node_shards, plan.n_slot_shards
    tile_bytes = sum(int(b.rows * 4 / ns + b.rows * b.width * 4 / (ns * ms))
                     for b in buckets)
    state_bytes = int(c.numel() * c.element_size() + ext_pad.numel() * 4
                      + node_tile.numel() * node_tile.element_size())
    peak = tile_bytes + state_bytes

    n_buckets = len(bg.buckets)
    bucket_rows = np.array([b.n_rows for b in bg.buckets], dtype=np.int64)
    padded_rows = [b.rows for b in buckets]
    adj = bg.bucket_adjacency()
    active = np.ones(n_buckets, dtype=bool)

    wire_bytes = c.element_size()
    limit = max_iter if max_iter is not None else max(4, n)
    inv_perm_dev = (
        torch.as_tensor(bg.inv_perm).to(dev)
        if on_sweep is not None and bg.inv_perm is not None else None
    )
    comm_per_iter: List[int] = []
    active_rows_per_iter: List[int] = []
    collective_bytes_per_iter: List[int] = []
    total = 0
    it = 0
    while it < limit:
        active_rows_per_iter.append(int(bucket_rows[active].sum()))
        collective_bytes_per_iter.append(
            measured_sweep_bytes(padded_rows, plan, cand, wire_bytes, active, frontier)
        )
        changed_vec, dirty_next = sweep(c, ext_pad, active, node_tile, buckets)
        # The sweep's one host synchronisation. Both vectors are replicated
        # by the collectives, so every rank takes the same branches below.
        host = torch.cat([changed_vec, dirty_next.to(torch.int64)]).cpu().numpy()
        changed_vec, dirty_next = host[:n_buckets], host[n_buckets:] > 0
        changed = int(changed_vec.sum())
        comm_per_iter.append(changed)
        total += changed
        it += 1
        if on_sweep is not None:
            # Contract: int32 values in original-id order, on the device.
            view = c[:-1].to(torch.int32, copy=True)
            if inv_perm_dev is not None:
                view = view[inv_perm_dev]
            on_sweep(it, view)
        if changed == 0:
            break
        if frontier:
            reach = adj[changed_vec > 0].any(axis=0)
            active = dirty_next & reach
    coreness = c[:-1].cpu().numpy().astype(np.int32)
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
        collective_bytes_per_iter=collective_bytes_per_iter,
    )


def make_distributed_decompose(plan: MeshPlan, **kw):
    """Adapter: DecomposeFn for :func:`repro_torch.core.dckcore.dc_kcore`."""
    return partial(decompose_distributed, plan=plan, **kw)


def device_external_info(
    g,
    keep_mask: np.ndarray,
    upper_mask: np.ndarray,
    plan: MeshPlan,
    chunk_slots: Optional[int] = None,
    stats=None,
    device="cuda",
) -> Tuple[np.ndarray, int]:
    """The E(v) boundary fold of :func:`repro_torch.graph.build.
    external_info` computed over the ranks, plus the bytes it moved.

    Each adjacency chunk's slots are split over every rank of the mesh;
    a rank counts the contributions of its slots (a neighbour in
    ``upper_mask`` of a node in ``keep_mask``) and one [rows] all-reduce
    per chunk sums them. The result equals the host pass at every
    ``chunk_slots`` (integer counts add up in any order), and ``stats``
    records the host pass's bookkeeping exactly.

    Returns ``(ext, bytes_moved)``: E(v) per surviving node in
    ``keep_mask`` order, and the per-rank bytes of the all-reduces (a
    ``2 (k-1)/k`` ring over ``k`` ranks; 0 when ``k == 1``).
    """
    from repro_torch.graph.build import _iter_adjacency_chunks, _resolve_chunk_slots

    dev = resolve_device(device)
    keep_mask = np.asarray(keep_mask, dtype=bool)
    upper_mask = np.asarray(upper_mask, dtype=bool)
    n = g.n_nodes
    k = plan.size
    keep_dev = torch.from_numpy(keep_mask).to(dev)
    # Sentinel-padded: pad slots point src at a real row and cols at n,
    # whose upper bit is False.
    upper_dev = torch.from_numpy(np.concatenate([upper_mask, [False]])).to(dev)

    ext_full = np.zeros(n, dtype=np.int64)
    budget = _resolve_chunk_slots(chunk_slots)
    # Host-pass transient model, mirrored term for term: persistent =
    # masks + accumulator, per-chunk = int64 src + 2x bool slot masks.
    persistent = keep_mask.nbytes + upper_mask.nbytes + ext_full.nbytes
    contributed = 0
    bytes_moved = 0
    for lo, hi, src, cols in _iter_adjacency_chunks(g, budget):
        src_pad = _pad_to(src.astype(np.int32), k, 0, lo)
        cols_pad = _pad_to(np.asarray(cols, dtype=np.int32), k, 0, n)
        per = src_pad.shape[0] // k
        s = torch.from_numpy(src_pad[plan.rank * per : (plan.rank + 1) * per]).to(dev).long()
        t = torch.from_numpy(cols_pad[plan.rank * per : (plan.rank + 1) * per]).to(dev).long()
        contributes = (keep_dev[s] & upper_dev[t]).to(torch.int32)
        part = torch.zeros(hi - lo, dtype=torch.int32, device=dev).index_add_(0, s - lo, contributes)
        if k > 1:
            _all_reduce(plan, part, plan.world_group)
            bytes_moved += int(2 * (k - 1) / k * (hi - lo) * 4)
        ext_full[lo:hi] = part.cpu().numpy()
        if stats is not None:
            stats.n_chunks += 1
            stats.input_slots += int(src.size)
            contributed += int(ext_full[lo:hi].sum())
            stats.bump(persistent + src.nbytes + src.size * 2)
    if stats is not None:
        stats.kept_slots += contributed
        stats.note_pass(2 * g.n_edges, contributed, slot_bytes=9, kept_bytes=8)
    return ext_full[keep_mask].astype(np.int32), bytes_moved
