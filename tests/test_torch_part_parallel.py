"""Part-parallel conquer in the port (``dc_kcore(part_parallel=S)``)
against the JAX package's.

* Thread slices on the CPU (the stream slices' code path, without the
  streams): coreness, every per-part report field but the timers (the
  placement stamps ``slice_index`` / ``wave`` / ``modeled_cost_bytes`` /
  ``retries`` included), the speculation counters and each conquer's
  ``comm_per_iter`` equal the reference's, over the sorted, count and fused
  engines, Rough and Exact, and S in {1, 2, 4}.
* Checkpoints and sweep snapshots: the final state equals the sequential
  run's, a crash at every part boundary and a crash mid-sweep resume to the
  same coreness, and a run crashed in one package resumes in the other.
* Chaos: a crash at every ``slice_conquer`` visit, a hang that blacklists,
  fail-fast main-thread sites, the watchdog's requirements.
* Rank slices: a four-rank gloo fleet (one child per rank) against the JAX
  package's device mode on four virtual devices, for a (4, 1) and a (2, 2)
  plan split into two slices; the split itself; the modeled collective
  term against a measured ``frontier=False`` run on each slice; a mid-sweep
  crash and resume; and the CLI's ``--devices 4`` from ``env://``.
* The CLI's part-parallel flags on the CPU.

All comparisons are exact.
"""
import contextlib
import dataclasses
import io
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from distributed_helpers import WorkerHarness, run_with_devices
from repro.core.dckcore import PipelineState as RefPipelineState
from repro.core.dckcore import dc_kcore as ref_dc_kcore
from repro.core.decompose import decompose as ref_decompose
from repro.graph.generators import rmat
from repro.graph.oracle import peel_coreness
from repro.runtime import FaultPlan as RefFaultPlan
from repro_torch.core.dckcore import PipelineState, dc_kcore
from repro_torch.core.decompose import decompose
from repro_torch.core.distributed import MeshPlan
from repro_torch.graph.structs import from_reference_arrays
from repro_torch.launch import kcore as port_cli
from repro_torch.runtime import FaultPlan, FaultSpec, InjectedFailure

torch.set_num_threads(1)

THRESHOLDS = (4, 10)
TIMERS = {"extract_time_s", "decompose_time_s", "save_time_s", "save_wall_s"}
COUNTERS = ("part_parallel", "prefetch_hits", "prefetch_misses", "speculation_discards",
            "boundary_exchange_bytes", "retries", "blacklisted_slices", "degraded_waves",
            "resumed_parts", "overlap")


@pytest.fixture(scope="module")
def graph():
    g = rmat(10, 8, seed=11)
    return g, from_reference_arrays(g), peel_coreness(g)


def _parts(rep):
    return [{k: v for k, v in dataclasses.asdict(p).items() if k not in TIMERS}
            for p in rep.parts]


def _assert_same_run(ref_rep, rep):
    assert _parts(rep) == _parts(ref_rep)
    for name in COUNTERS:
        assert getattr(rep, name) == getattr(ref_rep, name), name
    assert len(rep.slice_busy_s) == len(ref_rep.slice_busy_s)


def _recording(run):
    """A DecomposeFn that also records each conquer's (n_nodes,
    comm_per_iter); slice threads append concurrently, so the multiset is
    compared."""
    seen = []
    lock = threading.Lock()

    def fn(bg, **kw):
        res = run(bg, **kw)
        with lock:
            seen.append((int(bg.n_nodes), tuple(res.comm_per_iter)))
        return res
    return fn, seen


# --------------------------------------------------------------------- #
# Thread slices against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("strategy", ["rough", "exact"])
@pytest.mark.parametrize("engine", ["sorted", "count", "fused"])
def test_thread_mode_matches_reference(graph, engine, strategy, slices):
    g, pg, oracle = graph
    ref_fn, ref_seen = _recording(lambda bg, **kw: ref_decompose(bg, op=engine, **kw))
    fn, seen = _recording(lambda bg, **kw: decompose(bg, op=engine, device="cpu", **kw))
    ref_core, ref_rep = ref_dc_kcore(g, THRESHOLDS, strategy=strategy, decompose_fn=ref_fn,
                                     part_parallel=slices)
    core, rep = dc_kcore(pg, THRESHOLDS, strategy=strategy, decompose_fn=fn,
                         part_parallel=slices)
    np.testing.assert_array_equal(core, ref_core)
    np.testing.assert_array_equal(core, oracle)
    _assert_same_run(ref_rep, rep)
    assert sorted(seen) == sorted(ref_seen)
    assert rep.part_parallel == slices and len(rep.slice_busy_s) == slices
    assert all(p.slice_index >= 0 and p.wave >= 0 for p in rep.parts)
    assert len(rep.slice_utilization) == slices
    assert all(0.0 <= u <= 1.0 for u in rep.slice_utilization)
    if strategy == "exact":
        assert rep.speculation_discards == 0 and rep.prefetch_misses == 0


@pytest.mark.parametrize("engine,int16", [("fused", False), ("fused", True), ("kernel", False)])
def test_thread_mode_engine_option_matches_reference(graph, engine, int16):
    g, pg, _ = graph
    ref_core, ref_rep = ref_dc_kcore(g, THRESHOLDS, engine=engine, int16=int16,
                                     part_parallel=2)
    core, rep = dc_kcore(pg, THRESHOLDS, engine=engine, int16=int16, device="cpu",
                         part_parallel=2)
    np.testing.assert_array_equal(core, ref_core)
    _assert_same_run(ref_rep, rep)


@pytest.mark.parametrize("reorder", ["rcm", "bfs"])
def test_thread_mode_with_reorder(reorder):
    g = rmat(10, 8, seed=3)
    ref_core, ref_rep = ref_dc_kcore(g, THRESHOLDS, reorder=reorder, part_parallel=2)
    core, rep = dc_kcore(from_reference_arrays(g), THRESHOLDS, reorder=reorder,
                         device="cpu", part_parallel=2)
    np.testing.assert_array_equal(core, ref_core)
    _assert_same_run(ref_rep, rep)


def test_thread_mode_three_ways_one_answer():
    """Sequential, overlapped and three slices: one answer, equal to the
    reference's three-slice run."""
    g = rmat(10, 8, seed=7)
    pg = from_reference_arrays(g)
    seq, _ = dc_kcore(pg, (4, 10, 20), device="cpu")
    ovl, _ = dc_kcore(pg, (4, 10, 20), device="cpu", overlap=True)
    par, rep = dc_kcore(pg, (4, 10, 20), device="cpu", part_parallel=3)
    ref_core, ref_rep = ref_dc_kcore(g, (4, 10, 20), part_parallel=3)
    assert seq.tobytes() == ovl.tobytes() == par.tobytes() == ref_core.tobytes()
    _assert_same_run(ref_rep, rep)


def test_thread_mode_monolithic_and_many_slices():
    g = rmat(10, 8, seed=5)
    pg = from_reference_arrays(g)
    seq, _ = dc_kcore(pg, (), device="cpu")
    par, rep = dc_kcore(pg, (), device="cpu", part_parallel=4)
    ref_core, ref_rep = ref_dc_kcore(g, (), part_parallel=4)
    np.testing.assert_array_equal(par, seq)
    np.testing.assert_array_equal(par, ref_core)
    _assert_same_run(ref_rep, rep)
    assert sum(1 for b in rep.slice_busy_s if b > 0) <= len(rep.parts)


# --------------------------------------------------------------------- #
# Checkpoints, snapshots, resume
# --------------------------------------------------------------------- #
class SimulatedCrash(Exception):
    pass


def test_checkpoint_byte_identity(graph, tmp_path):
    """The sequential and part-parallel runs leave the same final state, and
    the reference's part-parallel run the same again."""
    g, pg, _ = graph
    dirs = {k: str(tmp_path / k) for k in ("seq", "par", "ref")}
    dc_kcore(pg, THRESHOLDS, device="cpu", checkpoint_dir=dirs["seq"])
    dc_kcore(pg, THRESHOLDS, device="cpu", checkpoint_dir=dirs["par"], part_parallel=2)
    ref_dc_kcore(g, THRESHOLDS, checkpoint_dir=dirs["ref"], part_parallel=2)
    states = [PipelineState.restore(dirs["seq"], g.n_nodes),
              PipelineState.restore(dirs["par"], g.n_nodes),
              RefPipelineState.restore(dirs["ref"], g.n_nodes)]
    for s in states[1:]:
        assert (s.parts_done, s.complete) == (states[0].parts_done, True)
        for name, arr in states[0].arrays().items():
            assert s.arrays()[name].tobytes() == arr.tobytes(), name
    par_reports = [{k: v for k, v in dataclasses.asdict(p).items() if k not in TIMERS}
                   for p in states[1].reports]
    ref_reports = [{k: v for k, v in dataclasses.asdict(p).items() if k not in TIMERS}
                   for p in states[2].reports]
    assert par_reports == ref_reports


def test_boundary_crash_storm(graph, tmp_path):
    """Kill the part-parallel run at every part boundary in turn; each
    resume (part-parallel too) converges to the reference's coreness with
    at most two retained steps."""
    g, pg, oracle = graph
    thresholds = (4, 10, 20)
    base, base_rep = ref_dc_kcore(g, thresholds)
    ck = str(tmp_path / "ck")

    def killer(idx, report):
        raise SimulatedCrash

    cycles = 0
    while True:
        try:
            core, rep = dc_kcore(pg, thresholds, device="cpu", part_parallel=2,
                                 checkpoint_dir=ck, resume=cycles > 0,
                                 on_part_done=killer if cycles < len(base_rep.parts) else None)
            break
        except SimulatedCrash:
            cycles += 1
            assert cycles < 50, "storm did not converge"
    np.testing.assert_array_equal(core, base)
    np.testing.assert_array_equal(core, oracle)
    assert cycles == len(base_rep.parts)
    steps = [d for d in os.listdir(ck) if d.startswith("step_") and not d.endswith(".tmp")]
    assert 1 <= len(steps) <= 2


def test_midsweep_crash_resumes(graph, tmp_path):
    g, pg, oracle = graph
    ck = str(tmp_path / "ck")
    calls = []

    def kill_at_second(cursor, sweep, save_s):
        calls.append((cursor, sweep, threading.current_thread().name))
        if len(calls) == 2:
            raise SimulatedCrash

    with pytest.raises(SimulatedCrash):
        dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=2, checkpoint_dir=ck,
                 sweep_checkpoint_every=1, on_sweep_saved=kill_at_second)
    # Only the wave's lead part saves snapshots, on its slice's thread.
    assert {c for c, _s, _t in calls} == {0}
    assert all(t.startswith("dckcore-conquer-") for _c, _s, t in calls)
    core, rep = dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=2, checkpoint_dir=ck,
                         resume=True, sweep_checkpoint_every=1)
    np.testing.assert_array_equal(core, oracle)
    assert any(p.resumed_at_sweep > 0 for p in rep.parts)


@pytest.mark.parametrize("crash", ["boundary", "midsweep"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cross_package_resume(graph, tmp_path, direction, crash):
    """A part-parallel run crashed in one package resumes in the other
    (part-parallel there too), to the same coreness and reports."""
    g, pg, oracle = graph
    thresholds = (4, 10, 20)
    first, then = ((ref_dc_kcore, g, {}), (dc_kcore, pg, {"device": "cpu"}))
    if direction == "torch_to_jax":
        first, then = then, first
    ck = str(tmp_path / "ck")
    kw = dict(part_parallel=2, checkpoint_dir=ck)
    if crash == "boundary":
        def killer(idx, report):
            raise SimulatedCrash
        crash_kw = dict(on_part_done=killer)
    else:
        calls = []

        def killer(cursor, sweep, save_s):
            calls.append(sweep)
            if len(calls) == 2:
                raise SimulatedCrash
        kw["sweep_checkpoint_every"] = 1
        crash_kw = dict(on_sweep_saved=killer)
    with pytest.raises(SimulatedCrash):
        first[0](first[1], thresholds, **first[2], **kw, **crash_kw)
    core, rep = then[0](then[1], thresholds, **then[2], **kw, resume=True)
    np.testing.assert_array_equal(core, oracle)
    if crash == "boundary":
        assert rep.resumed_parts == 1
    else:
        assert any(p.resumed_at_sweep > 0 for p in rep.parts)


# --------------------------------------------------------------------- #
# Chaos
# --------------------------------------------------------------------- #
def test_crash_at_every_slice_conquer_visit(graph):
    """A single crash at the k-th slice_conquer visit, for every k of the
    fault-free run (whose visit count equals the reference's): the run
    completes byte-identical with exactly that one retry accounted."""
    g, pg, oracle = graph
    probe, ref_probe = FaultPlan(), RefFaultPlan()
    core, _ = dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=2, max_retries=2,
                       fault_plan=probe)
    ref_dc_kcore(g, THRESHOLDS, part_parallel=2, max_retries=2, fault_plan=ref_probe)
    np.testing.assert_array_equal(core, oracle)
    n_visits = probe.visits("slice_conquer")
    assert n_visits == ref_probe.visits("slice_conquer") >= 3
    for k in range(n_visits):
        plan = FaultPlan([FaultSpec("slice_conquer", "crash", at=k)])
        core, rep = dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=2, max_retries=2,
                             fault_plan=plan)
        np.testing.assert_array_equal(core, oracle)
        assert len(plan.events) == 1, (k, plan.events)
        assert rep.retries == 1
        assert len([e for e in rep.fault_events if e["event"] == "retry"]) == 1
        assert sum(p.retries for p in rep.parts) <= 1


def test_hang_blacklists_and_degrades(graph):
    g, pg, oracle = graph
    plan = FaultPlan([FaultSpec("slice_conquer", "hang", at=0, delay_s=60.0)])
    core, rep = dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=2, slice_timeout_s=2.0,
                         max_retries=0, fault_plan=plan)
    np.testing.assert_array_equal(core, oracle)
    assert len(rep.blacklisted_slices) == 1 and rep.degraded_waves >= 1
    assert any(e["event"] == "blacklist" and e["reason"] == "hang" for e in rep.fault_events)


def test_mainthread_sites_fail_fast(graph, tmp_path):
    g, pg, _ = graph
    with pytest.raises(InjectedFailure):
        dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=2, max_retries=2,
                 fault_plan=FaultPlan([FaultSpec("boundary_fold", "crash")]))
    with pytest.raises(InjectedFailure):
        dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=2, max_retries=2,
                 checkpoint_dir=str(tmp_path / "ck"),
                 fault_plan=FaultPlan([FaultSpec("checkpoint_save", "crash")]))


def test_crash_then_resume_after_degraded_run(graph, tmp_path):
    g, pg, oracle = graph
    ck = str(tmp_path / "ck")
    plan = FaultPlan([FaultSpec("slice_conquer", "crash", at=0),
                      FaultSpec("checkpoint_save", "crash", at=1)])
    with pytest.raises(InjectedFailure):
        dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=2, checkpoint_dir=ck,
                 max_retries=0, fault_plan=plan)
    assert sorted(e["site"] for e in plan.events) == ["checkpoint_save", "slice_conquer"]
    core, rep = dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=2, checkpoint_dir=ck,
                         resume=True)
    np.testing.assert_array_equal(core, oracle)
    assert rep.resumed_parts >= 1


@pytest.mark.parametrize("option,match", [
    (dict(slice_timeout_s=1.0), "part_parallel"),
    (dict(max_retries=1), "part_parallel"),
    (dict(ckpt_retain=0), "ckpt_retain"),
    (dict(part_parallel=0), "part_parallel"),
    (dict(part_parallel=2, overlap=True), "overlap"),
    (dict(part_parallel=1, part_parallel_plan=MeshPlan(), decompose_fn=lambda bg: None),
     "decompose_fn"),
    (dict(part_parallel=1, part_parallel_plan=MeshPlan(), engine="fused"), "engine="),
])
def test_part_parallel_options_are_validated(graph, option, match):
    _, pg, _ = graph
    with pytest.raises(ValueError, match=match):
        dc_kcore(pg, THRESHOLDS, device="cpu", **option)


@pytest.mark.parametrize("option", [dict(slice_timeout_s=1.0), dict(max_retries=1)])
def test_rank_slice_watchdog_is_not_ported(graph, option):
    _, pg, _ = graph
    with pytest.raises(NotImplementedError, match="the watchdog on rank slices"):
        dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=1, part_parallel_plan=MeshPlan(),
                 **option)


def test_one_rank_plan_runs_one_slice(graph):
    """A 1x1 plan as one rank slice needs no process group: the distributed
    engine conquers every part, and the reference's one-device plan gives
    the same run."""
    import jax

    from repro.core.distributed import MeshPlan as RefMeshPlan

    g, pg, oracle = graph
    ref_plan = RefMeshPlan(mesh=jax.make_mesh((1, 1), ("data", "model")),
                           node_axes=("data",), slot_axes=("model",))
    ref_core, ref_rep = ref_dc_kcore(g, THRESHOLDS, part_parallel=1,
                                     part_parallel_plan=ref_plan)
    core, rep = dc_kcore(pg, THRESHOLDS, device="cpu", part_parallel=1,
                         part_parallel_plan=MeshPlan())
    np.testing.assert_array_equal(core, oracle)
    np.testing.assert_array_equal(core, ref_core)
    _assert_same_run(ref_rep, rep)
    assert rep.boundary_exchange_bytes == 0


# --------------------------------------------------------------------- #
# Rank slices: four gloo ranks against the JAX device mode
# --------------------------------------------------------------------- #
_SUMMARY = r"""
import dataclasses
TIMERS = {"extract_time_s", "decompose_time_s", "save_time_s", "save_wall_s"}
def summary(core, rep):
    return dict(coreness=core.tolist(),
                parts=[{k: v for k, v in dataclasses.asdict(p).items() if k not in TIMERS}
                       for p in rep.parts],
                counters=[rep.part_parallel, len(rep.slice_busy_s), rep.prefetch_hits,
                          rep.prefetch_misses, rep.speculation_discards,
                          rep.boundary_exchange_bytes])
"""

_REF_FLEET = r"""
import json
import jax, numpy as np
from repro.core.dckcore import dc_kcore
from repro.graph.generators import rmat
from repro.launch.mesh import make_mesh_plan_for_devices
assert len(jax.devices()) == 4, jax.devices()
""" + _SUMMARY + r"""
g = rmat(10, 8, seed=11)
out = {}
for mp in (1, 2):
    plan = make_mesh_plan_for_devices(4, model_parallel=mp)
    for strategy in ("exact", "rough"):
        core, rep = dc_kcore(g, thresholds=(4, 10), strategy=strategy, part_parallel=2,
                             part_parallel_plan=plan)
        out[f"{mp}-{strategy}"] = summary(core, rep)
print("RESULT " + json.dumps(out))
"""

_PORT_FLEET = r"""
import contextlib, io, json, os
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["REPRO_RANK"]), int(os.environ["REPRO_WORLD"])
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                  MASTER_PORT="{port}")
from repro_torch.core.dckcore import dc_kcore
from repro_torch.core.distributed import decompose_distributed
from repro_torch.core.partsched import cost_for_plan, slice_mesh_plans, spec_of
from repro_torch.graph.build import bucketize
from repro_torch.graph.generators import rmat
from repro_torch.graph.oracle import peel_coreness
from repro_torch.launch import kcore as cli
from repro_torch.launch.mesh import make_mesh_plan
""" + _SUMMARY + r"""
out = {}
# The CLI first: it initializes the process group from env:// (torchrun's
# variables), and the rest of this rank runs on that group.
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    cli.main(["--graph", "rmat:10:8", "--thresholds", "4,10", "--strategy", "exact",
              "--part-parallel", "2", "--devices", "4", "--device", "cpu", "--check",
              "--seed", "11"])
out["cli"] = buf.getvalue()
assert dist.is_initialized() and dist.get_world_size() == 4
g = rmat(10, 8, seed=11)
for mp in (1, 2):
    plan = make_mesh_plan((4 // mp, mp), ("data", "model"))
    for strategy in ("exact", "rough"):
        core, rep = dc_kcore(g, thresholds=(4, 10), strategy=strategy, part_parallel=2,
                             part_parallel_plan=plan, device="cpu")
        out[f"{mp}-{strategy}"] = summary(core, rep)
        out[f"{mp}-{strategy}-busy"] = len([b for b in rep.slice_busy_s if b > 0])
    slices = slice_mesh_plans(plan, 2)
    out[f"{mp}-split"] = [[list(p.shape), list(p.ranks), p.rank, p.node_index,
                           p.slot_index, p.world_group is not None] for p in slices]
    i = next(i for i, p in enumerate(slices) if p.rank >= 0)
    bg = bucketize(g)
    full = decompose_distributed(bg, slices[i], frontier=False, device="cpu")
    cost = cost_for_plan(bg, 7, spec_of(slices[i], i), frontier=False,
                         n_iters=full.iterations, full_sweeps=full.iterations)
    out[f"{mp}-pin"] = [i, cost.cursor, cost.collective_bytes,
                        sum(full.collective_bytes_per_iter)]
# A crash at the second sweep snapshot of the wave's lead part (on its
# slice's two ranks), then a resume; every rank checkpoints to its own dir.
class Crash(Exception):
    pass
ck = os.path.join("{tmp}", f"ck{rank}")
plan = make_mesh_plan((4, 1), ("data", "model"))
saves = []
def killer(cursor, sweep, save_s):
    saves.append(sweep)
    if len(saves) == 2:
        raise Crash
try:
    dc_kcore(g, thresholds=(4, 10), strategy="exact", part_parallel=2,
             part_parallel_plan=plan, device="cpu", checkpoint_dir=ck,
             sweep_checkpoint_every=1, on_sweep_saved=killer)
    out["crashed"] = False
except Crash:
    out["crashed"] = True
core, rep = dc_kcore(g, thresholds=(4, 10), strategy="exact", part_parallel=2,
                     part_parallel_plan=plan, device="cpu", checkpoint_dir=ck,
                     resume=True, sweep_checkpoint_every=1)
out["resume"] = dict(oracle=bool((core == peel_coreness(g)).all()),
                     resumed=[p.resumed_at_sweep for p in rep.parts],
                     saved=len(saves),
                     steps=len([d for d in os.listdir(ck) if d.startswith("step_")]))
print("RESULT " + json.dumps(out))
dist.destroy_process_group()
"""


def _result(stdout):
    lines = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
    assert len(lines) == 1, stdout
    return json.loads(lines[0][len("RESULT "):])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """The JAX package's device mode on four virtual devices, and four port
    ranks over gloo, each run once for the module's tests."""
    tmp = tmp_path_factory.mktemp("rank_slices")
    harness = WorkerHarness()
    code = _PORT_FLEET.replace("{port}", str(_free_port())).replace("{tmp}", str(tmp))
    try:
        for rank in range(4):
            harness.spawn(code, n_devices=1, rank=rank, world=4)
        reference = _result(run_with_devices(_REF_FLEET, n_devices=4))
        ranks = [_result(o) for o in harness.join(timeout=600)]
    finally:
        leaked = harness.terminate_leaked()
    assert not leaked, f"leaked fleet ranks {leaked}"
    return reference, ranks


@pytest.mark.parametrize("case", ["1-exact", "1-rough", "2-exact", "2-rough"])
def test_rank_slices_match_reference_device_mode(fleets, graph, case):
    reference, ranks = fleets
    _, _, oracle = graph
    for r, got in enumerate(ranks):
        assert got[case] == reference[case], f"rank {r}"
        assert got[f"{case}-busy"] == 2, f"rank {r}: both slices must conquer parts"
    assert reference[case]["coreness"] == oracle.tolist()
    part_parallel, n_busy, _hits, _misses, _discards, exchanged = reference[case]["counters"]
    assert (part_parallel, n_busy) == (2, 2) and exchanged > 0
    if case.endswith("exact"):
        # No miss: the wave's parts are all kept, one on each slice.
        assert reference[case]["counters"][3:5] == [0, 0]
        assert {p["slice_index"] for p in reference[case]["parts"]} == {0, 1}


@pytest.mark.parametrize("mp", [1, 2])
def test_rank_slices_split(fleets, mp):
    _, ranks = fleets
    shape = [2 // mp, mp]
    blocks = [[0, 1], [2, 3]]
    for r, got in enumerate(ranks):
        split = got[f"{mp}-split"]
        assert [s[0] for s in split] == [shape, shape]
        assert [s[1] for s in split] == blocks
        mine = [s for s in split if s[2] >= 0]
        assert len(mine) == 1 and r in mine[0][1]
        local = mine[0][1].index(r)
        coords = np.unravel_index(local, shape)
        assert mine[0][2:5] == [local, int(coords[0]), int(coords[1])]
        assert mine[0][5] is True  # a two-rank slice has its own world group
        assert all(s[5] is False for s in split if s[2] < 0)


@pytest.mark.parametrize("mp", [1, 2])
def test_rank_slices_modeled_cost_pinned_to_measured_bytes(fleets, mp):
    _, ranks = fleets
    for r, got in enumerate(ranks):
        i, cursor, modeled, measured = got[f"{mp}-pin"]
        assert i == r // 2 and cursor == 7
        assert modeled == measured > 0


def test_rank_slices_crash_and_resume(fleets):
    _, ranks = fleets
    for r, got in enumerate(ranks):
        assert got["crashed"] is True, f"rank {r}"
        res = got["resume"]
        assert res["oracle"] and any(s > 0 for s in res["resumed"]), f"rank {r}: {res}"
        assert 1 <= res["steps"] <= 2
    # Only the lead part's slice (two ranks) saved sweep snapshots.
    assert sorted(got["resume"]["saved"] for got in ranks) == [0, 0, 2, 2]
    assert len({json.dumps(got["resume"]["resumed"]) for got in ranks}) == 1


def test_rank_slices_cli_from_env(fleets):
    _, ranks = fleets
    for got in ranks:
        out = got["cli"]
        assert "CONSISTENT" in out
        assert "part-parallel: 2 slice(s)" in out
        exchanged = int(out.split("boundary-exchange bytes = ")[1].split()[0].replace(",", ""))
        assert exchanged > 0
        assert " slice=1 " in out and " slice=0 " in out


# --------------------------------------------------------------------- #
# The CLI on the CPU
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("argv,message", [
    (["--devices", "4"], "--devices requires --part-parallel"),
    (["--part-parallel", "2", "--overlap"], "subsumes --overlap"),
    (["--part-parallel", "2", "--devices", "4", "--engine", "fused"], "drop --engine"),
    (["--slice-capacity-gb", "1"], "--slice-capacity-gb requires --part-parallel"),
    (["--slice-timeout", "1"], "require --part-parallel"),
    (["--max-retries", "1"], "require --part-parallel"),
])
def test_cli_part_parallel_flag_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as ei:
        port_cli.main(["--graph", "rmat:8:8", "--device", "cpu"] + argv)
    assert ei.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_part_parallel_cpu_check(capsys):
    port_cli.main(["--graph", "rmat:10:8", "--thresholds", "4,10", "--engine", "fused",
                   "--part-parallel", "2", "--max-retries", "1", "--device", "cpu",
                   "--check", "--fault", "slice_conquer:crash:1"])
    out = capsys.readouterr().out
    assert "CONSISTENT" in out
    assert "part-parallel: 2 slice(s)" in out
    assert "fault tolerance: 1 part retry" in out
    assert "kernel launches: fused_sweep=0 hindex=0 partial_counts=0" in out


def test_capacity_replan_exhaustion_reraises(tmp_path):
    from repro_torch.core.partsched import SliceCapacityError

    g = from_reference_arrays(rmat(8, 4, seed=3))
    ck = str(tmp_path / "ck")
    calls = []
    exc = SliceCapacityError("part 0 fits no slice")

    def dc_stub(graph, thresholds, **kw):
        calls.append((tuple(thresholds), kw.get("resume")))
        raise exc

    with pytest.raises(SliceCapacityError) as ei:
        port_cli.run_with_capacity_replan(g, [4], replan_budget_bytes=1 << 20, max_replans=3,
                                          dc=dc_stub, checkpoint_dir=ck, resume=True)
    assert ei.value is exc
    assert len(calls) == 1 + 3
    assert calls[0][1] is True
    assert all(r is False for _, r in calls[1:])
    assert not os.path.exists(ck)


def test_capacity_replan_matches_reference():
    """The re-divide's threshold plans equal the reference launcher's, and
    a re-planned run completes once the parts fit."""
    from repro.launch.kcore import run_with_capacity_replan as ref_replan
    from repro.core.partsched import SliceCapacityError as RefCapacityError
    from repro_torch.core.partsched import SliceCapacityError

    g = rmat(9, 8, seed=3)
    pg = from_reference_arrays(g)

    def stub(error):
        seen = []

        def dc(graph, thresholds, **kw):
            seen.append(list(thresholds))
            if len(seen) < 3:
                raise error("too big")
            return np.zeros(graph.n_nodes, np.int32), None
        return dc, seen

    got, got_seen = stub(SliceCapacityError)
    want, want_seen = stub(RefCapacityError)
    with contextlib.redirect_stdout(io.StringIO()):
        out = port_cli.run_with_capacity_replan(pg, [4], replan_budget_bytes=1 << 16,
                                                dc=got, slice_capacity_bytes=1 << 14)
        ref_out = ref_replan(g, [4], replan_budget_bytes=1 << 16, dc=want,
                             slice_capacity_bytes=1 << 14)
    assert got_seen == want_seen and len(got_seen) == 3
    assert out[2] == ref_out[2] and out[3] == ref_out[3] == 2
