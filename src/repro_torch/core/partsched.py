"""Partition-level scheduler: conquer many planned parts concurrently.

The port of ``repro.core.partsched``. The sequential DC-kCore loop
(:mod:`repro_torch.core.dckcore`) conquers one part at a time; this module
lets a wave of parts conquer at once, the paper's story of many parts in
flight on limited resources. Three layers, kept apart so the planning layer
is pure numpy and ints and runs without a device:

* **Slices.** A slice is where one part conquers. In the port it is either
  a worker thread on the one card with its own CUDA stream (*stream
  slices*: ``dc_kcore(part_parallel=S)`` on a CUDA device), or a block of
  the ranks of a ``torch.distributed`` process group (*rank slices*:
  :func:`slice_mesh_plans` splits a :class:`~repro_torch.core.distributed.
  MeshPlan` along its first node axis, and each slice runs the distributed
  engine on its own sub-groups). The pure description of a slice is a
  :class:`SliceSpec` (shard counts and an optional per-device capacity),
  which duck-types the ``plan`` argument of
  :func:`~repro_torch.core.distributed.planned_collective_schedule`.

* **Cost model and assignment.** :func:`part_cost` prices a part's planned
  frontier schedule on a slice: the collective term is exactly
  ``sum(planned_collective_schedule(...))`` and the memory term prices each
  planned live set with :func:`repro_torch.roofline.kcore_model.sweep_cost`,
  so single-device slices still get a nonzero, size-ordered cost.
  :func:`assign_parts` is the longest-processing-time greedy: parts by
  descending cost, each onto the least-loaded slice whose capacity admits
  the part's modeled resident bytes. It is deterministic (ties break on
  cursor, then slice index) and total: a part that fits no slice raises
  :class:`SliceCapacityError`.

* **Wave executor.** :func:`conquer_wave` runs one planned wave: one worker
  thread per slice (named ``dckcore-conquer-<i>``), each conquering its
  parts in cursor order. By default a failure is re-raised once every slice
  has drained (the earliest cursor's wins). A :class:`WatchdogConfig` arms
  fault tolerance instead: failed parts retry on their slice with
  exponential backoff, per-slice heartbeats detect hangs, and a slice that
  hangs or runs out of retries is blacklisted with its unfinished parts
  re-planned over the survivors through :func:`assign_parts`. Parts are
  idempotent over immutable inputs, so a degraded wave stays byte-identical.

The wave planner in ``dckcore`` keeps every result byte-identical to the
sequential loop: part ``i+1`` is planned on the *predicted* shrink of part
``i`` (every candidate finalizes), and after the wave the predictions are
validated in plan order; the first miss discards the wave's tail.

Everything here but :func:`slice_mesh_plans` and
:func:`make_slice_decomposes` is the reference's code; the planning layer
equals it field for field (``tests/test_torch_partsched.py``).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.distributed import (
    MeshPlan,
    make_distributed_decompose,
    planned_collective_schedule,
    planned_live_sets,
)
from repro_torch.core.hindex import hindex_of_sequence
from repro_torch.roofline.kcore_model import sweep_cost

# Wave-conquer worker threads carry this name prefix; the test suite
# asserts none outlive a test (a leaked thread = a missing drain).
CONQUER_THREAD_PREFIX = "dckcore-conquer"


class SliceCapacityError(ValueError):
    """A part's modeled resident bytes fit no slice's capacity.

    Raised by :func:`assign_parts` instead of over-packing a slice: the
    caller (or the user, via a smaller ``--budget-gb`` divide) must plan
    smaller parts.
    """


@dataclasses.dataclass(frozen=True)
class SliceSpec:
    """Pure description of one slice -- the planning-layer unit.

    Duck-compatible with the ``plan`` argument of
    :func:`~repro_torch.core.distributed.planned_collective_schedule` (which
    reads only ``n_node_shards`` / ``n_slot_shards``). ``capacity_bytes`` is
    the per-device resident budget (``None`` = unbounded).
    """

    index: int
    n_node_shards: int
    n_slot_shards: int
    capacity_bytes: Optional[int] = None

    @property
    def n_devices(self) -> int:
        return self.n_node_shards * self.n_slot_shards


@dataclasses.dataclass(frozen=True)
class PartCost:
    """Modeled cost of conquering one planned part on a slice.

    ``collective_bytes`` is ``sum(planned_collective_schedule(...))`` over
    the part's bucket rows (zero on single-device slices); ``hbm_bytes``
    prices the same planned live sets' memory traffic per device;
    ``part_bytes`` is the modeled per-device resident footprint, checked
    against :attr:`SliceSpec.capacity_bytes`.
    """

    cursor: int
    collective_bytes: int
    hbm_bytes: int
    part_bytes: int

    @property
    def total(self) -> int:
        return self.collective_bytes + self.hbm_bytes


@dataclasses.dataclass(frozen=True)
class Assignment:
    cursor: int
    slice_index: int
    cost: PartCost


@dataclasses.dataclass(frozen=True)
class WaveSchedule:
    """One wave's part -> slice placement, in plan (cursor) order."""

    assignments: List[Assignment]
    n_slices: int

    def parts_for(self, slice_index: int) -> List[int]:
        """Cursors assigned to ``slice_index``, ascending (execution order)."""
        return sorted(
            a.cursor for a in self.assignments if a.slice_index == slice_index
        )

    def slice_loads(self) -> List[int]:
        """Total modeled cost per slice (the LPT objective)."""
        loads = [0] * self.n_slices
        for a in self.assignments:
            loads[a.slice_index] += a.cost.total
        return loads

    def decisions(self) -> List[dict]:
        """JSON-friendly schedule decisions."""
        return [
            {
                "cursor": a.cursor,
                "slice": a.slice_index,
                "modeled_collective_bytes": a.cost.collective_bytes,
                "modeled_hbm_bytes": a.cost.hbm_bytes,
                "modeled_part_bytes": a.cost.part_bytes,
            }
            for a in self.assignments
        ]


def cost_inputs_of(bg) -> tuple:
    """``(bucket_shapes, cand, n_nodes)`` of a bucketized part -- what
    :func:`part_cost` needs."""
    shapes = [(int(b.n_rows), int(b.width)) for b in bg.buckets]
    cand = max(1, hindex_of_sequence(bg.degrees.astype(np.int64) + bg.ext))
    return shapes, cand, int(bg.n_nodes)


def part_cost(
    bucket_shapes: Sequence[Sequence[int]],
    cand: int,
    n_nodes: int,
    spec: SliceSpec,
    *,
    wire_bytes: int = 4,
    n_iters: int = 30,
    full_sweeps: int = 3,
    decay: float = 0.6,
    frontier: bool = True,
) -> PartCost:
    """Model one part's conquer cost on ``spec`` from its bucket shapes.

    The planned frontier schedule (``full_sweeps`` full iterations, then
    geometric decay concentrated in the densest classes -- the knobs and
    live sets of :func:`planned_collective_schedule`) prices both terms, so
    the collective term of a ``frontier=False`` cost equals a measured run's
    collective bytes.
    """
    rows = [int(r) for r, _w in bucket_shapes]
    ns = max(1, spec.n_node_shards)
    padded = [math.ceil(r / ns) * ns for r in rows]
    coll = sum(
        planned_collective_schedule(
            rows, spec, cand, wire_bytes=wire_bytes, n_iters=n_iters,
            full_sweeps=full_sweeps, decay=decay, frontier=frontier,
        )
    ) if spec.n_devices > 1 else 0
    hbm = 0
    for live in planned_live_sets(
        padded, n_iters=n_iters, full_sweeps=full_sweeps, decay=decay,
        frontier=frontier,
    ):
        b, _f = sweep_cost(
            [(padded[bi], bucket_shapes[bi][1]) for bi in live],
            cand, wire_bytes=wire_bytes, fused=False, track_dirty=frontier,
        )
        hbm += b // spec.n_devices
    # Per-device resident footprint: sharded tiles + replicated state
    # (coreness wire + int32 ext + int16 node->bucket map).
    tile_bytes = sum(pr * max(1, w) * 4 for pr, (_r, w) in zip(padded, bucket_shapes))
    part_bytes = tile_bytes // spec.n_devices + (n_nodes + 1) * (wire_bytes + 4 + 2)
    return PartCost(
        cursor=-1,
        collective_bytes=int(coll),
        hbm_bytes=int(hbm),
        part_bytes=int(part_bytes),
    )


def cost_for_plan(bg, cursor: int, spec: SliceSpec, **kw) -> PartCost:
    """:func:`part_cost` of a bucketized part, stamped with its cursor."""
    shapes, cand, n = cost_inputs_of(bg)
    c = part_cost(shapes, cand, n, spec, **kw)
    return dataclasses.replace(c, cursor=cursor)


def assign_parts(
    costs: Sequence[PartCost], slices: Sequence[SliceSpec]
) -> WaveSchedule:
    """Place parts on slices: longest-processing-time greedy.

    Parts are taken descending by modeled total cost (ties ascending by
    cursor), each placed on the least-loaded slice whose ``capacity_bytes``
    admits the part's modeled resident footprint (ties ascending by slice
    index). No parts gives an empty schedule; more parts than slices queue
    (each slice runs its parts in cursor order); more slices than parts
    leave the trailing slices idle.
    """
    if not slices:
        raise ValueError("assign_parts needs at least one slice")
    if len({s.index for s in slices}) != len(slices):
        raise ValueError("duplicate slice indices")
    order = sorted(costs, key=lambda c: (-c.total, c.cursor))
    loads: Dict[int, int] = {s.index: 0 for s in slices}
    out: List[Assignment] = []
    for c in order:
        fits = [
            s for s in slices
            if s.capacity_bytes is None or c.part_bytes <= s.capacity_bytes
        ]
        if not fits:
            raise SliceCapacityError(
                f"part cursor={c.cursor} needs {c.part_bytes} resident "
                f"bytes/device but no slice admits it (capacities: "
                f"{[s.capacity_bytes for s in slices]}) — plan smaller parts"
            )
        best = min(fits, key=lambda s: (loads[s.index], s.index))
        loads[best.index] += c.total
        out.append(Assignment(cursor=c.cursor, slice_index=best.index, cost=c))
    out.sort(key=lambda a: a.cursor)
    return WaveSchedule(assignments=out, n_slices=len(slices))


# --------------------------------------------------------------------- #
# Mesh layer: rank slices of a process group's mesh.
# --------------------------------------------------------------------- #
def slice_mesh_plans(plan: MeshPlan, n_slices: int) -> List[MeshPlan]:
    """Split ``plan``'s mesh into ``n_slices`` equal sub-meshes.

    The split runs along the FIRST node axis (parts shard rows over node
    axes, so every slice stays a valid layout for the distributed engine);
    its size must be divisible by ``n_slices``. Each slice keeps the axis
    names and node / slot axes, and records the ranks it holds
    (``MeshPlan.ranks``, a block of ``plan.ranks``). Every rank of the
    process group must call this, in the same order: it creates every
    slice's node, slot and world groups. Only the slice that holds this
    process carries live groups; the others have ``rank == -1``.
    """
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if not plan.node_axes:
        raise ValueError("cannot slice a plan with no node axes")
    axis = plan.node_axes[0]
    pos = plan.axis_names.index(axis)
    size = plan.shape[pos]
    if size % n_slices != 0:
        raise ValueError(
            f"node axis {axis!r} has {size} shards — not divisible into "
            f"{n_slices} slices; pick a slice count dividing the axis"
        )
    if len(plan.ranks) != plan.size:
        raise ValueError(f"plan of shape {plan.shape} lists ranks {plan.ranks}")
    from repro_torch.launch.mesh import sub_mesh_plan

    me = plan.ranks[plan.rank] if plan.rank >= 0 else -1
    grid = np.asarray(plan.ranks, dtype=np.int64).reshape(plan.shape)
    return [
        sub_mesh_plan(plan, block.shape, block.ravel().tolist(), me)
        for block in np.split(grid, n_slices, axis=pos)
    ]


def spec_of(plan: MeshPlan, index: int,
            capacity_bytes: Optional[int] = None) -> SliceSpec:
    """The pure :class:`SliceSpec` of a concrete slice plan."""
    return SliceSpec(
        index=index,
        n_node_shards=plan.n_node_shards,
        n_slot_shards=plan.n_slot_shards,
        capacity_bytes=capacity_bytes,
    )


def make_slice_decomposes(plan: MeshPlan, n_slices: int, **kw):
    """``(slice_plans, decompose_fns)`` for rank-slice ``dc_kcore``: one
    :func:`~repro_torch.core.distributed.make_distributed_decompose` per
    slice of ``plan``, all sharing the engine kwargs (``use_kernel``,
    ``wire_dtype``, ``frontier``, ``device``, ...). A slice that does not
    hold this process is never called on it."""
    plans = slice_mesh_plans(plan, n_slices)
    return plans, [make_distributed_decompose(p, **kw) for p in plans]


# --------------------------------------------------------------------- #
# Wave executor.
# --------------------------------------------------------------------- #
class SliceHangError(RuntimeError):
    """The watchdog declared a slice hung: no heartbeat (sweep progress)
    within ``slice_timeout_s`` while a part was in flight."""


@dataclasses.dataclass
class WatchdogConfig:
    """Fault-tolerance knobs for :func:`conquer_wave`.

    ``slice_timeout_s``: declare a slice dead after this long without a
    heartbeat while a part is in flight (``None`` = never; crashes are
    still retried). ``max_retries``: failed attempts per part on the same
    slice before the slice is blacklisted. ``backoff_s``: base of the
    exponential retry backoff. ``poll_s``: watchdog poll period.
    ``drain_timeout_s``: how long the caller waits for abandoned worker
    threads after the wave settles (injected hangs are released and always
    end; a truly wedged thread past this is reported in telemetry).
    """

    slice_timeout_s: Optional[float] = None
    max_retries: int = 2
    backoff_s: float = 0.05
    poll_s: float = 0.02
    drain_timeout_s: float = 10.0


@dataclasses.dataclass
class WaveTelemetry:
    """What the fault-tolerance layer did during one wave."""

    retries: int = 0
    blacklisted: List[int] = dataclasses.field(default_factory=list)
    replans: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)

    def record(self, event: str, **ctx):
        self.events.append({"event": event, **ctx})

    @property
    def degraded(self) -> bool:
        return bool(self.blacklisted)


def _accepts_heartbeat(fn) -> bool:
    try:
        return "heartbeat" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class _WaveRunner:
    """One wave's execution state: per-slice work queues, heartbeats,
    retry/blacklist bookkeeping. All mutable state is guarded by one
    condition variable; ``run_part`` itself runs outside the lock."""

    def __init__(self, schedule, run_part, slices, watchdog, fault_plan, tel):
        self.schedule = schedule
        self.run_part = run_part
        self.wd = watchdog
        self.fault_plan = fault_plan
        self.tel = tel
        self.fail_fast = watchdog is None
        self.hb_aware = _accepts_heartbeat(run_part)
        if slices is None:
            slices = [SliceSpec(index=s, n_node_shards=1, n_slot_shards=1)
                      for s in range(schedule.n_slices)]
        self.slices = list(slices)
        self.cond = threading.Condition()
        self.queues: Dict[int, List[int]] = {
            sp.index: schedule.parts_for(sp.index) for sp in self.slices
        }
        self.costs: Dict[int, PartCost] = {
            a.cursor: a.cost for a in schedule.assignments
        }
        self.n_parts = len(schedule.assignments)
        self.results: Dict[int, object] = {}
        self.done: set = set()
        self.inflight: Dict[int, int] = {}     # slice index -> cursor
        self.beat: Dict[int, float] = {}       # slice index -> monotonic
        self.dead: Dict[int, BaseException] = {}
        self.failures: List[tuple] = []        # fail-fast: (cursor, exc)
        self.fatal: Optional[tuple] = None     # (cursor, exc): FT exhausted
        self.stop = False

    # -- lifecycle ----------------------------------------------------- #
    def run(self) -> Dict[int, object]:
        threads = [
            threading.Thread(
                target=self._worker, args=(sp.index,), daemon=True,
                name=f"{CONQUER_THREAD_PREFIX}-{sp.index}",
            )
            for sp in self.slices
        ]
        for t in threads:
            t.start()
        try:
            if not self.fail_fast:
                self._monitor()
        finally:
            # Fail-fast workers drain their static queues and exit on their
            # own; raising ``stop`` early would race them into dropping
            # work. Only watchdog workers park for re-plans and need the
            # explicit wake-up once the monitor settles.
            if not self.fail_fast:
                with self.cond:
                    self.stop = True
                    self.cond.notify_all()
                if self.fault_plan is not None:
                    # The monitor exits only once the wave settled, so a
                    # worker still parked in an injected hang is abandoned:
                    # wake it now so the drain does not wait out the hang.
                    self.fault_plan.release()
            deadline = self.wd.drain_timeout_s if self.wd else None
            for t in threads:
                t.join(timeout=deadline)
            if any(t.is_alive() for t in threads) and self.fault_plan is not None:
                self.fault_plan.release()
                for t in threads:
                    t.join(timeout=deadline)
            for t in threads:
                if t.is_alive():
                    self.tel.record("thread_leak", thread=t.name)
        if self.fail_fast and self.failures:
            self.failures.sort(key=lambda f: f[0])
            raise self.failures[0][1]
        if self.fatal is not None:
            raise self.fatal[1]
        return self.results

    def _monitor(self):
        with self.cond:
            while len(self.done) < self.n_parts and self.fatal is None:
                if self.wd.slice_timeout_s is not None:
                    now = time.monotonic()
                    for idx, cur in list(self.inflight.items()):
                        if idx in self.dead:
                            continue
                        if now - self.beat.get(idx, now) > self.wd.slice_timeout_s:
                            self._declare_dead(
                                idx, cur,
                                SliceHangError(
                                    f"slice {idx} hung on part cursor={cur}: no "
                                    f"heartbeat for {self.wd.slice_timeout_s}s"
                                ),
                                reason="hang",
                            )
                self.cond.wait(timeout=self.wd.poll_s)

    # -- blacklist + re-plan (cond held) ------------------------------- #
    def _declare_dead(self, idx: int, cur: Optional[int],
                      exc: BaseException, reason: str):
        if idx in self.dead:
            return
        self.dead[idx] = exc
        self.inflight.pop(idx, None)
        self.tel.blacklisted.append(idx)
        self.tel.record("blacklist", slice=idx, cursor=cur, reason=reason,
                        error=repr(exc))
        unfinished = [c for c in ([cur] if cur is not None else [])
                      if c not in self.done]
        unfinished += self.queues[idx]
        self.queues[idx] = []
        survivors = [sp for sp in self.slices if sp.index not in self.dead]
        if not survivors:
            self.fatal = (cur if cur is not None else -1, exc)
        elif unfinished:
            try:
                sub = assign_parts([self.costs[c] for c in unfinished], survivors)
            except SliceCapacityError as ce:
                self.fatal = (unfinished[0], ce)
            else:
                self.tel.replans += 1
                self.tel.record(
                    "replan", cursors=sorted(unfinished),
                    survivors=[sp.index for sp in survivors],
                )
                for a in sub.assignments:
                    self.queues[a.slice_index].append(a.cursor)
                for q in self.queues.values():
                    q.sort()
        self.cond.notify_all()

    # -- per-slice worker ---------------------------------------------- #
    def _worker(self, idx: int):
        def heartbeat(*_a, **_k):
            with self.cond:
                self.beat[idx] = time.monotonic()

        while True:
            with self.cond:
                cur = None
                while cur is None:
                    if self.stop or idx in self.dead or self.fatal is not None:
                        return
                    if self.queues[idx]:
                        cur = self.queues[idx].pop(0)
                        self.inflight[idx] = cur
                        self.beat[idx] = time.monotonic()
                        break
                    if self.fail_fast or len(self.done) >= self.n_parts:
                        # Fail-fast queues are static: an empty queue means
                        # this slice is drained. Watchdog workers park for
                        # re-plans until the whole wave settles.
                        return
                    self.cond.wait(timeout=0.05)
            attempt = 0
            while True:
                try:
                    if self.fault_plan is not None:
                        self.fault_plan.visit(
                            "slice_conquer", cursor=cur, slice=idx,
                            attempt=attempt,
                        )
                    if self.hb_aware:
                        out = self.run_part(cur, idx, heartbeat=heartbeat)
                    else:
                        out = self.run_part(cur, idx)
                except BaseException as e:  # noqa: BLE001 -- retried/re-raised
                    with self.cond:
                        if idx in self.dead or self.stop:
                            return  # abandoned mid-attempt; result not wanted
                        if self.fail_fast:
                            self.failures.append((cur, e))
                            self.inflight.pop(idx, None)
                            self.cond.notify_all()
                            return
                        attempt += 1
                        if attempt > self.wd.max_retries:
                            self._declare_dead(idx, cur, e, reason="crash")
                            return
                        self.tel.retries += 1
                        self.tel.record("retry", slice=idx, cursor=cur,
                                        attempt=attempt, error=repr(e))
                        self.beat[idx] = time.monotonic()
                    time.sleep(self.wd.backoff_s * (2 ** (attempt - 1)))
                    continue
                with self.cond:
                    if idx in self.dead:
                        # Declared hung while (slowly) finishing: the part
                        # was re-planned, and the survivor's byte-identical
                        # result is the one committed.
                        self.tel.record("discarded_result", slice=idx, cursor=cur)
                        return
                    self.results[cur] = out
                    self.done.add(cur)
                    self.inflight.pop(idx, None)
                    self.cond.notify_all()
                break


def conquer_wave(
    schedule: WaveSchedule,
    run_part: Callable[[int, int], object],
    *,
    slices: Optional[Sequence[SliceSpec]] = None,
    watchdog: Optional[WatchdogConfig] = None,
    fault_plan=None,
    telemetry: Optional[WaveTelemetry] = None,
) -> Dict[int, object]:
    """Run one wave: each slice conquers its assigned parts concurrently.

    ``run_part(cursor, slice_index)`` conquers one part and returns its
    result; each slice's parts run in ascending cursor order on that
    slice's worker thread. If ``run_part`` accepts a ``heartbeat`` keyword
    it receives a zero-arg callable to signal liveness (the pipeline wires
    it into the engine's per-sweep ``on_sweep`` hook).

    Default (``watchdog=None``) is fail-fast: every slice drains before
    this returns; on failure the earliest-cursor exception is re-raised,
    and no worker thread outlives the call either way.

    With a :class:`WatchdogConfig` the wave is fault-tolerant: a failed
    part is retried on its slice with exponential backoff up to
    ``max_retries``; a slice whose heartbeat stalls past
    ``slice_timeout_s`` (or that exhausts its retries) is blacklisted and
    its unfinished parts are re-planned over the surviving slices via
    :func:`assign_parts`. Only when no slice survives (or a re-plan hits
    :class:`SliceCapacityError`) does the wave raise. ``telemetry`` (a
    :class:`WaveTelemetry`) collects retry / blacklist / re-plan events;
    ``fault_plan`` (:class:`repro_torch.runtime.FaultPlan`) is visited at
    the ``slice_conquer`` site before each attempt. ``slices`` carries the
    actual :class:`SliceSpec` s (needed to re-plan; default unit specs
    indexed ``0 .. n_slices-1``).
    """
    tel = telemetry if telemetry is not None else WaveTelemetry()
    runner = _WaveRunner(schedule, run_part, slices, watchdog, fault_plan, tel)
    return runner.run()
