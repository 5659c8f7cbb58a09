"""The port's partition scheduler (``repro_torch.core.partsched``) against
the JAX package's, and the kernel wrappers' launch counters under threads.

* Planning layer: ``assign_parts``, ``part_cost`` and ``cost_for_plan``
  equal the reference's field for field on seeded random costs, bucket
  shapes and slice specs, ``SliceCapacityError`` and the validation errors
  included (as ``tests/test_part_parallel.py`` pins the reference).
* ``conquer_wave``: fail-fast, retry, blacklist and re-plan, hang, all
  slices dead and re-plan capacity exhaustion, each run through both
  packages' executors with the same expectations (as
  ``tests/test_fault_tolerance.py`` pins the reference).
* ``slice_mesh_plans``: its errors carry the reference's messages, and a
  plan of one-rank slices splits without a process group.
* Launch counters: several threads launch through each wrapper's dispatch
  and count launches at once; the totals and per-thread tallies are exact.

All comparisons are exact.
"""
import dataclasses
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import distributed as ref_dist
from repro.core import partsched as ref
from repro.graph.build import bucketize as ref_bucketize
from repro.graph.generators import rmat
from repro import runtime as ref_runtime
from repro_torch import runtime as port_runtime
from repro_torch.core import partsched as port
from repro_torch.core.distributed import MeshPlan
from repro_torch.graph.structs import from_reference_arrays
from repro_torch.kernels.counts import partial_counts_op, partial_counts_plain
from repro_torch.kernels.fused import fused_sweep_op, fused_sweep_plain
from repro_torch.kernels.hindex import hindex_op, hindex_plain
from repro_torch.kernels.plan import count_launch

torch.set_num_threads(1)

PACKAGES = [pytest.param(ref, id="jax"), pytest.param(port, id="torch")]


# --------------------------------------------------------------------- #
# Planning layer
# --------------------------------------------------------------------- #
def _costs(pkg, rows):
    return [pkg.PartCost(cursor=c, collective_bytes=cb, hbm_bytes=hb, part_bytes=pb)
            for c, cb, hb, pb in rows]


def _specs(pkg, caps, shards=None):
    shards = shards or [(1, 1)] * len(caps)
    return [pkg.SliceSpec(index=i, n_node_shards=ns, n_slot_shards=ms, capacity_bytes=cap)
            for i, (cap, (ns, ms)) in enumerate(zip(caps, shards))]


def _schedule_fields(s):
    return ([(a.cursor, a.slice_index, dataclasses.astuple(a.cost), a.cost.total)
             for a in s.assignments],
            s.n_slices, s.slice_loads(), s.decisions(),
            [s.parts_for(i) for i in range(s.n_slices)])


def _assign_both(rows, caps):
    """``assign_parts`` in both packages: the schedule's fields, or the
    error's type name and message."""
    out = []
    for pkg in (ref, port):
        try:
            out.append(_schedule_fields(pkg.assign_parts(_costs(pkg, rows), _specs(pkg, caps))))
        except ValueError as exc:
            out.append((type(exc).__name__, str(exc)))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_assign_parts_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n_parts = int(rng.integers(0, 10))
        n_slices = int(rng.integers(1, 6))
        # Few distinct costs, so the tie-breaks (cursor, slice index) decide.
        rows = [(c, int(rng.integers(0, 4)) * 1000, int(rng.integers(0, 3)) * 500,
                 int(rng.integers(1, 1 << 16))) for c in rng.permutation(n_parts).tolist()]
        if rng.random() < 0.5:
            caps = [None] * n_slices
        else:
            caps = [None if rng.random() < 0.2 else int(rng.integers(1, 1 << 17))
                    for _ in range(n_slices)]
        want, got = _assign_both(rows, caps)
        assert got == want


def test_assign_parts_capacity_error_and_validation_match_reference():
    want, got = _assign_both([(0, 5, 0, 1000)], [10, 100])
    assert want[0] == "SliceCapacityError" and got == want
    for pkg in (ref, port):
        assert issubclass(pkg.SliceCapacityError, ValueError)
    for slices in ([], [(0, 1, 1), (0, 1, 1)]):
        msgs = []
        for pkg in (ref, port):
            with pytest.raises(ValueError) as ei:
                pkg.assign_parts(_costs(pkg, [(0, 1, 0, 1)]),
                                 [pkg.SliceSpec(*s) for s in slices])
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("seed", range(8))
def test_part_cost_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        nb = int(rng.integers(0, 7))
        shapes = [(int(rng.integers(0, 300)), int(2 ** rng.integers(0, 9))) for _ in range(nb)]
        cand = int(rng.integers(1, 200))
        n_nodes = int(rng.integers(1, 5000))
        ns, ms = (int(v) for v in rng.choice([1, 2, 4], size=2))
        cap = None if rng.random() < 0.5 else int(rng.integers(1, 1 << 20))
        kw = dict(wire_bytes=int(rng.choice([2, 4])), n_iters=int(rng.integers(1, 40)),
                  full_sweeps=int(rng.integers(0, 5)), decay=float(rng.choice([0.5, 0.6, 0.9])),
                  frontier=bool(rng.random() < 0.5))
        want = ref.part_cost(shapes, cand, n_nodes, ref.SliceSpec(2, ns, ms, cap), **kw)
        got = port.part_cost(shapes, cand, n_nodes, port.SliceSpec(2, ns, ms, cap), **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.total == want.total


@pytest.mark.parametrize("shards", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_cost_for_plan_matches_reference(shards):
    bg = ref_bucketize(rmat(10, 8, seed=11))
    pbg = from_reference_arrays(bg)
    assert port.cost_inputs_of(pbg) == ref.cost_inputs_of(bg)
    for kw in ({}, {"frontier": False, "n_iters": 7, "full_sweeps": 7}):
        want = ref.cost_for_plan(bg, 3, ref.SliceSpec(1, *shards), **kw)
        got = port.cost_for_plan(pbg, 3, port.SliceSpec(1, *shards), **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.cursor == 3


def test_single_device_cost_is_collective_free_but_ordered():
    spec1 = port.SliceSpec(index=0, n_node_shards=1, n_slot_shards=1)
    small = port.part_cost([(16, 8)], 8, 16, spec1)
    big = port.part_cost([(64, 8), (16, 32)], 8, 80, spec1)
    assert small.collective_bytes == big.collective_bytes == 0
    assert 0 < small.total < big.total
    assert small.part_bytes < big.part_bytes


# --------------------------------------------------------------------- #
# conquer_wave, through both packages' executors
# --------------------------------------------------------------------- #
def _schedule(pkg, n_parts, n_slices):
    costs = [pkg.PartCost(cursor=c, collective_bytes=100, hbm_bytes=0, part_bytes=1)
             for c in range(n_parts)]
    slices = [pkg.SliceSpec(index=s, n_node_shards=1, n_slot_shards=1)
              for s in range(n_slices)]
    return pkg.assign_parts(costs, slices), slices


@pytest.mark.parametrize("pkg", PACKAGES)
def test_conquer_wave_runs_all_on_named_threads(pkg):
    sched, _ = _schedule(pkg, 5, 2)
    ran = []
    out = pkg.conquer_wave(sched, lambda cur, s: ran.append(
        (cur, s, threading.current_thread().name)) or cur * 2)
    assert out == {c: c * 2 for c in range(5)}
    assert sorted((c, s) for c, s, _ in ran) == sorted(
        (a.cursor, a.slice_index) for a in sched.assignments)
    assert all(name == f"dckcore-conquer-{s}" for _c, s, name in ran)
    # Each slice runs its parts in ascending cursor order.
    for s in range(2):
        mine = [c for c, sl, _ in ran if sl == s]
        assert mine == sorted(mine) == sched.parts_for(s)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_conquer_wave_fail_fast_raises_earliest_cursor(pkg):
    sched, slices = _schedule(pkg, 4, 2)

    def run_part(cursor, s):
        if cursor in (1, 2):
            raise RuntimeError(f"boom {cursor}")
        return cursor * 10

    with pytest.raises(RuntimeError, match="boom 1"):
        pkg.conquer_wave(sched, run_part, slices=slices)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_conquer_wave_retry_commits_identical_result(pkg):
    sched, slices = _schedule(pkg, 4, 2)
    fails = {1: 2}
    tel = pkg.WaveTelemetry()

    def run_part(cursor, s):
        if fails.get(cursor, 0) > 0:
            fails[cursor] -= 1
            raise RuntimeError("transient")
        return cursor * 10

    results = pkg.conquer_wave(sched, run_part, slices=slices, telemetry=tel,
                               watchdog=pkg.WatchdogConfig(max_retries=2, backoff_s=0.001))
    assert results == {c: c * 10 for c in range(4)}
    assert (tel.retries, tel.blacklisted, tel.replans) == (2, [], 0)
    assert [e["attempt"] for e in tel.events if e["event"] == "retry"] == [1, 2]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_conquer_wave_exhausted_retries_blacklist_and_replan(pkg):
    sched, slices = _schedule(pkg, 6, 2)
    victim = sched.parts_for(0)[0]
    tel = pkg.WaveTelemetry()

    def run_part(cursor, s):
        if cursor == victim and s == 0:
            raise RuntimeError("slice 0 is broken")
        return cursor * 10

    results = pkg.conquer_wave(sched, run_part, slices=slices, telemetry=tel,
                               watchdog=pkg.WatchdogConfig(max_retries=1, backoff_s=0.001))
    assert results == {c: c * 10 for c in range(6)}
    assert tel.blacklisted == [0] and tel.replans == 1 and tel.degraded
    kinds = [e["event"] for e in tel.events]
    assert kinds.count("retry") == 1 and "blacklist" in kinds and "replan" in kinds
    replan = next(e for e in tel.events if e["event"] == "replan")
    assert replan["survivors"] == [1] and replan["cursors"] == sched.parts_for(0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_conquer_wave_hang_is_declared_dead_and_replanned(pkg):
    sched, slices = _schedule(pkg, 4, 2)
    victim = sched.parts_for(1)[0]
    unhang = threading.Event()
    tel = pkg.WaveTelemetry()

    def run_part(cursor, s, heartbeat=None):
        if cursor == victim and s == 1:
            unhang.wait(timeout=10)
            raise RuntimeError("woke from hang")
        heartbeat()
        return cursor * 10

    try:
        results = pkg.conquer_wave(
            sched, run_part, slices=slices, telemetry=tel,
            watchdog=pkg.WatchdogConfig(slice_timeout_s=0.2, poll_s=0.02, max_retries=0,
                                        drain_timeout_s=5.0))
    finally:
        unhang.set()
    assert results == {c: c * 10 for c in range(4)}
    assert tel.blacklisted == [1]
    assert any(e["event"] == "blacklist" and e["reason"] == "hang" for e in tel.events)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_conquer_wave_all_slices_dead_raises(pkg):
    sched, slices = _schedule(pkg, 3, 2)

    def run_part(cursor, s):
        raise RuntimeError("every slice is broken")

    with pytest.raises(RuntimeError, match="every slice is broken"):
        pkg.conquer_wave(sched, run_part, slices=slices,
                         watchdog=pkg.WatchdogConfig(max_retries=0, backoff_s=0.001))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_conquer_wave_replan_capacity_exhaustion_raises(pkg):
    costs = [pkg.PartCost(cursor=0, collective_bytes=100, hbm_bytes=0, part_bytes=100)]
    slices = [pkg.SliceSpec(0, 1, 1, capacity_bytes=200), pkg.SliceSpec(1, 1, 1, capacity_bytes=10)]
    sched = pkg.assign_parts(costs, slices)

    def run_part(cursor, s):
        raise RuntimeError("slice 0 is broken")

    with pytest.raises(pkg.SliceCapacityError):
        pkg.conquer_wave(sched, run_part, slices=slices,
                         watchdog=pkg.WatchdogConfig(max_retries=0, backoff_s=0.001))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_conquer_wave_visits_slice_conquer_before_each_attempt(pkg):
    runtime = ref_runtime if pkg is ref else port_runtime
    FaultPlan, FaultSpec = runtime.FaultPlan, runtime.FaultSpec
    sched, slices = _schedule(pkg, 4, 2)
    plan = FaultPlan([FaultSpec("slice_conquer", "crash", at=1)])
    tel = pkg.WaveTelemetry()
    results = pkg.conquer_wave(sched, lambda c, s: c, slices=slices, fault_plan=plan,
                               telemetry=tel,
                               watchdog=pkg.WatchdogConfig(max_retries=1, backoff_s=0.001))
    assert results == {c: c for c in range(4)}
    assert plan.visits("slice_conquer") == 5  # 4 parts + the retried attempt
    assert tel.retries == 1 and len(plan.events) == 1


# --------------------------------------------------------------------- #
# slice_mesh_plans
# --------------------------------------------------------------------- #
def _ref_plan(node_axes=("data",), slot_axes=("model",)):
    return ref_dist.MeshPlan(mesh=jax.make_mesh((1, 1), ("data", "model")),
                             node_axes=node_axes, slot_axes=slot_axes)


@pytest.mark.parametrize("n_slices,axes", [(0, "default"), (2, "default"), (1, "none")])
def test_slice_mesh_plans_errors_match_reference(n_slices, axes):
    if axes == "none":
        ref_plan = _ref_plan(node_axes=(), slot_axes=("data", "model"))
        port_plan = MeshPlan(node_axes=(), slot_axes=("data", "model"))
    else:
        ref_plan, port_plan = _ref_plan(), MeshPlan()
    with pytest.raises(ValueError) as want:
        ref.slice_mesh_plans(ref_plan, n_slices)
    with pytest.raises(ValueError) as got:
        port.slice_mesh_plans(port_plan, n_slices)
    assert str(got.value) == str(want.value)


def test_slice_mesh_plans_one_rank_slices_need_no_group():
    """A (4, 1) plan seen from rank 2 splits into two (2, 1) slices whose
    groups need a process group, so use a (2, 1) plan: two one-rank slices,
    each recording its rank, and only rank 1's slice holds this process."""
    plan = MeshPlan(shape=(2, 1), rank=1, node_index=1, ranks=(0, 1))
    slices = port.slice_mesh_plans(plan, 2)
    assert [s.ranks for s in slices] == [(0,), (1,)]
    assert [s.shape for s in slices] == [(1, 1), (1, 1)]
    assert [(s.rank, s.node_index, s.slot_index) for s in slices] == [(-1, -1, -1), (0, 0, 0)]
    assert all(s.world_group is None and s.node_group is None for s in slices)
    specs = [port.spec_of(s, i, 7) for i, s in enumerate(slices)]
    assert specs == [port.SliceSpec(0, 1, 1, 7), port.SliceSpec(1, 1, 1, 7)]
    whole = port.slice_mesh_plans(MeshPlan(), 1)
    assert [(s.shape, s.ranks, s.rank) for s in whole] == [((1, 1), (0,), 0)]


# --------------------------------------------------------------------- #
# Launch counters under threads
# --------------------------------------------------------------------- #
def _inputs(seed=0, n=64, rows=16, width=8):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(np.concatenate([rng.integers(0, 9, n), [-1]]).astype(np.int32))
    ext_pad = torch.from_numpy(np.concatenate([rng.integers(0, 3, n), [0]]).astype(np.int32))
    ids = torch.from_numpy(rng.permutation(n)[:rows].astype(np.int32))
    neigh = torch.from_numpy(rng.integers(0, n + 1, (rows, width)).astype(np.int32))
    return c, ext_pad, ids, neigh


def test_launch_counters_exact_under_threads():
    """Eight threads each call the three wrappers through their dispatch
    (CPU tensors: the plain versions, which count nothing) and count 2,000
    launches per wrapper; a short switch interval makes the interpreter
    swap threads inside the counting. Totals and per-thread tallies are
    exact, and every dispatched call equals its plain version."""
    ops = (fused_sweep_op, hindex_op, partial_counts_op)
    saved = [(op.launches, dict(op.launches_by_thread)) for op in ops]
    n_threads, per_thread = 8, 2000
    errors = []
    c, ext_pad, ids, neigh = _inputs()
    x = c[neigh].contiguous()
    e = ext_pad[ids].contiguous()
    want = (fused_sweep_plain(c, ext_pad, ids, neigh, cand=6),
            hindex_plain(x, e, cand=6), partial_counts_plain(x, e, cand=6))

    def work():
        try:
            got = (fused_sweep_op(c, ext_pad, ids, neigh, cand=6),
                   hindex_op(x, e, cand=6), partial_counts_op(x, e, cand=6))
            for g_, w_ in zip([*got[0], got[1], got[2]], [*want[0], want[1], want[2]]):
                assert torch.equal(g_, w_)
            for _ in range(per_thread):
                for op in ops:
                    count_launch(op)
        except BaseException as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    try:
        for op in ops:
            op.launches = 0
            op.launches_by_thread.clear()
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work, name=f"counter-{i}") for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sys.setswitchinterval(interval)
        assert not errors, errors
        for op in ops:
            assert op.launches == n_threads * per_thread
            assert op.launches_by_thread == {f"counter-{i}": per_thread
                                             for i in range(n_threads)}
    finally:
        sys.setswitchinterval(interval)
        for op, (n, by) in zip(ops, saved):
            op.launches = n
            op.launches_by_thread.clear()
            op.launches_by_thread.update(by)
