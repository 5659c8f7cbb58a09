"""The port's distributed conquer engine against the JAX package's.

* One rank, in process: ``decompose_distributed`` on a 1x1 plan against the
  JAX engine on a 1x1 mesh (the main pytest process's one CPU device):
  every ``DecomposeResult`` field but the wall time, over ``use_kernel`` x
  ``frontier``, the int16 wire, an RCM layout, ``init_coreness`` and the
  ``on_sweep`` snapshots, and ``dc_kcore`` with ``make_distributed_decompose``.
* The shape math (collective bytes, the planned schedule, the node -> tile
  map) for every mesh shape of ``test_distributed_kcore.py``, with one
  duck-typed plan for both packages.
* Four ranks: gloo fleets over a ``file://`` store (one child interpreter
  per rank), against the JAX engine on four virtual devices in one child:
  a (2, 2) data x model plan with the counts kernel path, a (4,) data plan
  with the int16 wire, and ``device_external_info`` against the host fold.

All comparisons are exact.
"""
import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_helpers import run_with_devices
from repro.core import distributed as ref_dist
from repro.core.dckcore import dc_kcore as ref_dc_kcore
from repro.graph.build import bucketize as ref_bucketize
from repro.graph.generators import rmat
from repro.graph.oracle import peel_coreness
from repro.graph.reorder import reorder_graph as ref_reorder
from repro_torch.core import distributed as port_dist
from repro_torch.core.dckcore import dc_kcore
from repro_torch.core.decompose import DecomposeResult
from repro_torch.graph.structs import from_reference_arrays
from repro_torch.launch.mesh import make_mesh_plan

torch.set_num_threads(1)

PLAN = port_dist.MeshPlan()


@functools.lru_cache(maxsize=None)
def _ref_plan():
    return ref_dist.MeshPlan(mesh=jax.make_mesh((1, 1), ("data", "model")),
                             node_axes=("data",), slot_axes=("model",))


@functools.lru_cache(maxsize=None)
def _graph(scale=9):
    return rmat(scale, 8, seed=7)


@functools.lru_cache(maxsize=None)
def _bucketed(reorder="identity"):
    return ref_bucketize(ref_reorder(_graph(), reorder))


def _assert_result_equal(ref, port):
    assert isinstance(port, DecomposeResult)
    for f in dataclasses.fields(ref):
        if f.name == "wall_time_s":
            continue
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _both(bg, ref_kw=None, **kw):
    ref = ref_dist.decompose_distributed(bg, _ref_plan(), **(ref_kw or kw))
    port = port_dist.decompose_distributed(from_reference_arrays(bg), PLAN,
                                           device="cpu", **kw)
    return ref, port


# --------------------------------------------------------------------- #
# One rank, in process
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("frontier", [True, False])
def test_one_rank_matches_reference(use_kernel, frontier):
    ref, port = _both(_bucketed(), use_kernel=use_kernel, frontier=frontier)
    _assert_result_equal(ref, port)
    np.testing.assert_array_equal(port.coreness, peel_coreness(_graph()))
    assert port.collective_bytes_per_iter == [0] * port.iterations


def test_one_rank_int16_wire():
    ref, port = _both(_bucketed(), ref_kw=dict(wire_dtype=jnp.int16),
                      wire_dtype=torch.int16)
    _assert_result_equal(ref, port)
    with pytest.raises(ValueError, match="wire_dtype"):
        port_dist.decompose_distributed(from_reference_arrays(_bucketed()), PLAN,
                                        wire_dtype=torch.int64, device="cpu")


def test_one_rank_reordered_layout():
    ref, port = _both(_bucketed("rcm"), use_kernel=True)
    _assert_result_equal(ref, port)


def test_one_rank_on_sweep_snapshots_and_init_coreness():
    bg = _bucketed("rcm")
    ref_views, port_views = {}, {}
    ref, port = _both(
        bg,
        ref_kw=dict(on_sweep=lambda it, v: ref_views.update({it: np.asarray(v)})),
        on_sweep=lambda it, v: port_views.update({it: v.numpy().copy()}),
    )
    _assert_result_equal(ref, port)
    assert sorted(ref_views) == sorted(port_views) == list(range(1, port.iterations + 1))
    for it in ref_views:
        assert port_views[it].dtype == np.int32
        np.testing.assert_array_equal(port_views[it], ref_views[it])
    # Warm restart from the second sweep's snapshot, in both packages.
    snap = ref_views[2]
    ref2, port2 = _both(bg, init_coreness=snap)
    _assert_result_equal(ref2, port2)
    np.testing.assert_array_equal(port2.coreness, port.coreness)
    assert port2.iterations < port.iterations


def test_dc_kcore_with_distributed_engine_matches_reference():
    g = _graph(10)
    ref_core, ref_rep = ref_dc_kcore(
        g, thresholds=(4, 10),
        decompose_fn=ref_dist.make_distributed_decompose(_ref_plan(), use_kernel=True))
    core, rep = dc_kcore(
        from_reference_arrays(g), thresholds=(4, 10),
        decompose_fn=port_dist.make_distributed_decompose(PLAN, use_kernel=True, device="cpu"))
    np.testing.assert_array_equal(core, ref_core)
    np.testing.assert_array_equal(core, peel_coreness(g))
    timers = {"extract_time_s", "decompose_time_s", "save_time_s", "save_wall_s"}
    assert len(rep.parts) == len(ref_rep.parts) == 3
    for a, b in zip(ref_rep.parts, rep.parts):
        for f in dataclasses.fields(a):
            if f.name not in timers:
                assert getattr(a, f.name) == getattr(b, f.name), f.name


def test_default_device_never_falls_back():
    bg = from_reference_arrays(_bucketed())
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_dist.decompose_distributed(bg, PLAN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_dist.device_external_info(from_reference_arrays(_graph()),
                                       np.ones(512, bool), np.zeros(512, bool), PLAN)


def test_one_rank_plan_needs_no_process_group():
    plan = make_mesh_plan((1, 1))
    assert (plan.n_node_shards, plan.n_slot_shards, plan.size) == (1, 1, 1)
    assert plan.node_group is plan.slot_group is plan.world_group is None
    with pytest.raises(ValueError, match="every axis"):
        make_mesh_plan((1, 1), node_axes=("data",), slot_axes=())
    with pytest.raises(RuntimeError, match="initialized"):
        make_mesh_plan((2, 2))


# --------------------------------------------------------------------- #
# Shape math, every mesh shape of test_distributed_kcore.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,axes,node_axes", [
    ((4, 2), ("data", "model"), ("data",)),
    ((8,), ("data",), ("data",)),
    ((2, 2), ("data", "model"), ("data",)),
    ((4,), ("data",), ("data",)),
    ((1, 2), ("data", "model"), ("data",)),
    ((2,), ("data",), ("data",)),
])
def test_shape_math_matches_reference(shape, axes, node_axes):
    slot_axes = tuple(a for a in axes if a == "model")
    port_plan = port_dist.MeshPlan(shape=shape, axis_names=axes,
                                   node_axes=node_axes, slot_axes=slot_axes)
    ns, ms = port_plan.n_node_shards, port_plan.n_slot_shards
    assert ns * ms == int(np.prod(shape))
    plan = types.SimpleNamespace(n_node_shards=ns, n_slot_shards=ms)
    bg = _bucketed()
    pbg = from_reference_arrays(bg)
    cand = 30
    rows = [b.n_rows for b in bg.buckets]
    padded = [-(-r // ns) * ns for r in rows]
    nb = len(rows)
    act = np.zeros(nb, bool)
    act[: nb // 2] = True
    for wire in (4, 2):
        for active in (None, act):
            assert (port_dist.sweep_collective_bytes(pbg, plan, cand, wire, active)
                    == ref_dist.sweep_collective_bytes(bg, plan, cand, wire, active))
        # The JAX counter reads the global padded shapes of its sharded arrays.
        dev_buckets = [(np.zeros(p, np.int32), None) for p in padded]
        for active in (np.ones(nb, bool), act):
            for frontier in (True, False):
                assert (port_dist.measured_sweep_bytes(padded, plan, cand, wire, active, frontier)
                        == ref_dist.measured_sweep_bytes(dev_buckets, plan, cand, wire,
                                                         active, frontier))
        for frontier in (True, False):
            kw = dict(wire_bytes=wire, n_iters=12, frontier=frontier)
            assert (port_dist.planned_collective_schedule(rows, plan, cand, **kw)
                    == ref_dist.planned_collective_schedule(rows, plan, cand, **kw))
    assert (port_dist.planned_live_sets(padded, n_iters=9)
            == ref_dist.planned_live_sets(padded, n_iters=9))
    got, want = port_dist.node_tile_map(pbg), ref_dist.node_tile_map(bg)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # The port's row and slot blocks tile the padded bucket exactly.
    b = bg.buckets[-1]
    blocks = {}
    for ni in range(ns):
        for si in range(ms):
            p = dataclasses.replace(port_plan, node_index=ni, slot_index=si)
            sb = port_dist.shard_buckets(pbg, p, "cpu")[-1]
            assert (sb.rows, sb.width) == (padded[-1], -(-b.width // ms) * ms)
            blocks[ni, si] = sb.neigh.numpy()
    full = np.block([[blocks[ni, si] for si in range(ms)] for ni in range(ns)])
    want_full = ref_dist._pad_to(ref_dist._pad_to(np.asarray(b.neigh), ns, 0, bg.n_nodes),
                                 ms, 1, bg.n_nodes)
    np.testing.assert_array_equal(full, want_full)


# --------------------------------------------------------------------- #
# Four ranks: gloo fleets against the JAX engine on four virtual devices
# --------------------------------------------------------------------- #
_REF_FLEET = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from repro.core.distributed import (MeshPlan, decompose_distributed,
                                    device_external_info, make_distributed_decompose)
from repro.core.dckcore import dc_kcore
from repro.graph.build import DivideStats, bucketize
from repro.graph.generators import rmat
assert len(jax.devices()) == 4, jax.devices()
g = rmat(9, 8, seed=7)
bg = bucketize(g)
def summary(r):
    return dict(coreness=r.coreness.tolist(), comm=r.comm_per_iter,
                rows=r.active_rows_per_iter, coll=r.collective_bytes_per_iter,
                peak=r.peak_bytes)
p22 = MeshPlan(mesh=jax.make_mesh((2, 2), ("data", "model")), node_axes=("data",),
               slot_axes=("model",))
p4 = MeshPlan(mesh=jax.make_mesh((4,), ("data",)), node_axes=("data",), slot_axes=())
out = {"2x2": summary(decompose_distributed(bg, p22, use_kernel=True)),
       "4": summary(decompose_distributed(bg, p4, wire_dtype=jnp.int16))}
core, rep = dc_kcore(g, thresholds=(4, 10),
                     decompose_fn=make_distributed_decompose(p22, use_kernel=True))
out["dc"] = dict(coreness=core.tolist(), parts=[
    [p.iterations, p.comm_amount, p.collective_bytes, p.peak_bytes, p.gathered_rows]
    for p in rep.parts])
keep = np.random.default_rng(0).random(g.n_nodes) < 0.7
stats = DivideStats(chunk_slots=512)
ext, moved = device_external_info(g, keep, ~keep, p22, chunk_slots=512, stats=stats)
out["ext"] = dict(ext=ext.tolist(), moved=moved, stats=stats.__dict__)
print("RESULT " + json.dumps(out))
"""

_PORT_FLEET = r"""
import json, os
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["REPRO_RANK"]), int(os.environ["REPRO_WORLD"])
dist.init_process_group("gloo", init_method="file://{store}", rank=rank, world_size=world)
from repro_torch.core.distributed import (decompose_distributed, device_external_info,
                                          make_distributed_decompose)
from repro_torch.core.dckcore import dc_kcore
from repro_torch.graph.build import DivideStats, bucketize
from repro_torch.graph.generators import rmat
from repro_torch.launch.mesh import make_mesh_plan
g = rmat(9, 8, seed=7)
bg = bucketize(g)
def summary(r):
    return dict(coreness=r.coreness.tolist(), comm=r.comm_per_iter,
                rows=r.active_rows_per_iter, coll=r.collective_bytes_per_iter,
                peak=r.peak_bytes)
case = "{case}"
if case == "2x2":
    plan = make_mesh_plan((2, 2), ("data", "model"))
    out = dict(summary(decompose_distributed(bg, plan, use_kernel=True, device="cpu")),
               blocks=[plan.node_index, plan.slot_index])
    core, rep = dc_kcore(g, thresholds=(4, 10), decompose_fn=make_distributed_decompose(
        plan, use_kernel=True, device="cpu"))
    out["dc"] = dict(coreness=core.tolist(), parts=[
        [p.iterations, p.comm_amount, p.collective_bytes, p.peak_bytes, p.gathered_rows]
        for p in rep.parts])
elif case == "4":
    plan = make_mesh_plan((4,), ("data",))
    out = dict(summary(decompose_distributed(bg, plan, wire_dtype=torch.int16,
                                             device="cpu")),
               blocks=[plan.node_index, plan.slot_index])
else:
    plan = make_mesh_plan((2, 2), ("data", "model"))
    keep = np.random.default_rng(0).random(g.n_nodes) < 0.7
    stats = DivideStats(chunk_slots=512)
    ext, moved = device_external_info(g, keep, ~keep, plan, chunk_slots=512,
                                      stats=stats, device="cpu")
    out = dict(ext=ext.tolist(), moved=moved, stats=stats.__dict__)
print("RESULT " + json.dumps(out))
dist.destroy_process_group()
"""


def _result(stdout):
    lines = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
    assert len(lines) == 1, stdout
    return json.loads(lines[0][len("RESULT "):])


@pytest.fixture(scope="module")
def reference_fleet():
    return _result(run_with_devices(_REF_FLEET, n_devices=4))


def _run_fleet(worker_harness, tmp_path, case):
    code = _PORT_FLEET.replace("{store}", str(tmp_path / "store")).replace("{case}", case)
    for rank in range(4):
        worker_harness.spawn(code, n_devices=1, rank=rank, world=4)
    outs = [_result(o) for o in worker_harness.join(timeout=300)]
    blocks = [o.pop("blocks", None) for o in outs]
    assert all(o == outs[0] for o in outs), "ranks disagree"
    return outs[0], blocks


def test_fleet_2x2_counts_kernel_path(worker_harness, tmp_path, reference_fleet):
    got, blocks = _run_fleet(worker_harness, tmp_path, "2x2")
    want = reference_fleet["2x2"]
    assert got.pop("dc") == reference_fleet["dc"]
    assert got == want
    assert got["coreness"] == peel_coreness(_graph()).tolist()
    assert sorted(map(tuple, blocks)) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_fleet_data_axis_int16_wire(worker_harness, tmp_path, reference_fleet):
    got, blocks = _run_fleet(worker_harness, tmp_path, "4")
    assert got == reference_fleet["4"]
    assert sorted(b[0] for b in blocks) == [0, 1, 2, 3]


def test_fleet_device_external_info(worker_harness, tmp_path, reference_fleet):
    from repro.graph.build import DivideStats, external_info

    got, _ = _run_fleet(worker_harness, tmp_path, "ext")
    assert got == reference_fleet["ext"]
    g = _graph()
    keep = np.random.default_rng(0).random(g.n_nodes) < 0.7
    stats = DivideStats(chunk_slots=512)
    assert got["ext"] == external_info(g, keep, ~keep, chunk_slots=512, stats=stats).tolist()
    assert got["stats"] == stats.__dict__
    assert got["moved"] > 0
