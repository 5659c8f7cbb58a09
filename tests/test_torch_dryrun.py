"""Differential tests of the port's paper-scale dry-run
(``repro_torch.launch.kcore_dryrun``, ``roofline/{analysis,tally}.py``, the
meta branch of the counts op and the data-independent dirty push) against
the JAX package's ``repro.launch.kcore_dryrun``.

The reference runs in a child interpreter: importing its dry-run sets
``XLA_FLAGS`` to 512 host devices, which would reach every later test of a
worker whose JAX has not started yet. The child resets the flag to 8 devices
before JAX starts, lays the reference's production mesh as (2, 2, 2) over
them and writes its records under a temporary directory. The port runs in
process on a fake 8-rank (2, 2, 2) plan; every fake process group is
destroyed on the way out of its ``with``.
"""
import contextlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as ref_dist
from repro.graph.build import bucketize as ref_bucketize
from repro.graph.generators import rmat as ref_rmat
from repro.roofline.analysis import parse_collectives
from repro_torch.core import distributed as port_dist
from repro_torch.graph import bucketize, rmat
from repro_torch.graph.structs import from_reference_arrays
from repro_torch.kernels.counts import partial_counts_op, partial_counts_plain
from repro_torch.launch import kcore_dryrun as port_kd
from repro_torch.launch import mesh as port_mesh
from repro_torch.roofline import analysis, hw
from repro_torch.roofline.tally import Tally, record_kernel, top_holders

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_NM = [(1 << 16, 1 << 20), (1000, 5000), (1 << 20, 1 << 22), (3_000_000, 40_000_000)]
PURE_CASES = list(port_kd.WORKLOADS) + [f"{n}x{m}" for n, m in SMALL_NM]
# (label, n, m, cand, wire): one traced case per wire, one skipped on ids
# (n + 1 >= 2^31), one skipped on memory on 8 ranks under both budgets.
RECORD_CASES = [
    ("small", 1 << 16, 1 << 20, None, "int32"),
    ("small", 1 << 16, 1 << 20, None, "int16"),
    ("ids", 2**31 + 5, 2**33, 512, "int16"),
    ("memory", 2**30, 2**37, 1024, "int32"),
]
SLICE_CASES = [(name, s) for name in port_kd.WORKLOADS for s in (2, 4)]

_REF_CHILD = r"""
import json, os, sys
import repro.launch.kcore_dryrun as kd  # sets XLA_FLAGS to 512 host devices on import
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"  # before JAX starts
import jax
import repro.launch.mesh as ref_mesh
from repro.compat import make_mesh

ref_mesh.make_production_mesh = lambda multi_pod=False: make_mesh(
    (2, 2, 2), ("pod", "data", "model"))
assert len(jax.devices()) == 8, jax.devices()
kd.ARTIFACT_DIR = sys.argv[1]
spec = json.loads(sys.argv[2])
out = {"pure": {}, "records": [], "slices": []}
for label, (n, m) in spec["pure"].items():
    alpha, buckets = kd.powerlaw_bucket_rows(n, m)
    out["pure"][label] = [alpha, buckets, kd.degseq_hindex(buckets)]
for label, n, m, cand, wire in spec["records"]:
    if cand is None:
        cand = kd.degseq_hindex(kd.powerlaw_bucket_rows(n, m)[1])
    out["records"].append(kd.run_case(label, n, m, cand, wire))
for name, s in spec["slices"]:
    n, m, t, kmax = kd.WORKLOADS[name]
    out["slices"].append(kd.run_slices(name, n, m, t, kmax, "int32", s))
print(json.dumps(out))
"""


def _pure_nm(label):
    if label in port_kd.WORKLOADS:
        return port_kd.WORKLOADS[label][:2]
    return tuple(int(x) for x in label.split("x"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's numbers, from a child started at once; the tests
    compute the port's side while it runs and ``reference()`` waits."""
    spec = {"pure": {label: _pure_nm(label) for label in PURE_CASES},
            "records": RECORD_CASES, "slices": SLICE_CASES}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_CHILD, str(tmp_path_factory.mktemp("ref_dryrun")),
         json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    result = {}

    def get():
        if not result:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"reference child failed:\n{stderr[-4000:]}"
            result.update(json.loads(stdout.strip().splitlines()[-1]))
        return result

    try:
        yield get
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@contextlib.contextmanager
def _port_mesh(monkeypatch, tmp_path, shape=(2, 2, 2)):
    """The port's production plan as ``shape`` over a fake process group of
    that many ranks, records under ``tmp_path``."""
    axes = ("pod", "data", "model")[-len(shape):]
    monkeypatch.setattr(port_kd, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(port_mesh, "make_production_plan",
                        lambda multi_pod=False: port_mesh.make_mesh_plan(shape, axes))
    with port_mesh.fake_process_group(int(np.prod(shape))):
        yield


def _meta_state(n, wire_dtype):
    meta = torch.device("meta")
    return (torch.empty(n + 1, dtype=wire_dtype, device=meta),
            torch.empty(n + 1, dtype=torch.int32, device=meta),
            torch.empty(n + 1, dtype=torch.int16, device=meta))


# --------------------------------------------------------------------- #
# The pure model functions
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("label", PURE_CASES)
def test_model_functions_match_reference(reference, label):
    alpha, buckets = port_kd.powerlaw_bucket_rows(*_pure_nm(label))
    ref_alpha, ref_buckets, ref_h = reference()["pure"][label]
    assert alpha == ref_alpha
    assert [list(b) for b in buckets] == ref_buckets
    assert port_kd.degseq_hindex(buckets) == ref_h


# --------------------------------------------------------------------- #
# Records of run_case
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("i", range(len(RECORD_CASES)),
                         ids=[f"{c[0]}-{c[4]}" for c in RECORD_CASES])
def test_records_match_reference(reference, monkeypatch, tmp_path, i):
    label, n, m, cand, wire = RECORD_CASES[i]
    if cand is None:
        cand = port_kd.degseq_hindex(port_kd.powerlaw_bucket_rows(n, m)[1])
    with _port_mesh(monkeypatch, tmp_path):
        rec = port_kd.run_case(label, n, m, cand, wire)
    ref = reference()["records"][i]
    for key in ("case", "n", "m", "alpha", "mesh", "cand", "wire", "id_dtype",
                "memory_model", "modeled_collectives"):
        assert rec[key] == ref[key], key
    assert rec["fits_80gb"] == (label != "ids" and rec["memory_model"]["total_dev"]
                                < hw.HBM_BYTES)
    on_disk = json.loads((tmp_path / f"{label}__2x16x16.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    if "skipped_compile" in ref:
        assert not rec["fits_80gb"] and not ref["fits_16gb"]
        assert rec["skipped_compile"] == ref["skipped_compile"]
        assert not {"trace_s", "peak_temp_bytes", "collectives", "roofline"} & set(rec)
        return
    assert {"trace_s", "peak_temp_bytes", "hbm_bytes", "int_ops", "collectives",
            "roofline"} <= set(rec)
    assert not {"compile_s", "xla_temp_bytes", "fits_16gb"} & set(rec)
    assert rec["peak_temp_bytes"] > 0 and rec["hbm_bytes"] > 0 and rec["int_ops"] > 0
    # The wire bytes within 1% of the reference's parse_collectives total.
    # Op counts per kind may differ where XLA combines all-gathers (they
    # agree on this build); the bytes are what the roofline reads.
    port_wire = sum(rec["collectives"]["wire_bytes"].values())
    ref_wire = sum(ref["collectives"]["wire_bytes"].values())
    assert abs(port_wire - ref_wire) <= 0.01 * ref_wire
    assert rec["roofline"]["wire_bytes_per_device"] == port_wire
    # Every group of the 8-rank mesh lies in one NVLink node.
    assert rec["collectives"]["link_wire_bytes"] == {"nvlink": port_wire}


@pytest.mark.parametrize("name,n_slices", SLICE_CASES)
def test_slices_match_reference(reference, monkeypatch, tmp_path, name, n_slices):
    monkeypatch.setattr(port_kd, "ARTIFACT_DIR", str(tmp_path))
    n, m, t, kmax = port_kd.WORKLOADS[name]
    rec = port_kd.run_slices(name, n, m, t, kmax, "int32", n_slices)
    ref = reference()["slices"][SLICE_CASES.index((name, n_slices))]
    assert json.loads(json.dumps(rec["decisions"])) == ref["decisions"]
    assert rec["slice_loads"] == ref["slice_loads"]
    assert rec["slice_utilization"] == ref["slice_utilization"]


@pytest.mark.parametrize("name", list(port_kd.WORKLOADS))
def test_cli_records_every_case(monkeypatch, tmp_path, name):
    """``--wire int16`` and ``--split3`` write a record for each case the
    reference writes; the ids that reach 2^31 skip the trace, every other
    case carries the tally's numbers."""
    monkeypatch.setattr(port_kd, "ARTIFACT_DIR", str(tmp_path))
    t = port_kd.WORKLOADS[name][2]
    port_kd.main(["--case", name, "--wire", "int16"])
    port_kd.main(["--case", name, "--split3", "--wire", "int16"])
    assert not torch.distributed.is_initialized()
    labels = [f"{name}-mono", f"{name}-top(t={t})", f"{name}-rest(t={t})",
              f"{name}-3p-top(t={t})", f"{name}-3p-mid(8<d<{t})", f"{name}-3p-bottom(d<=8)"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{label}__2x16x16.json" for label in labels)
    for label in labels:
        rec = json.loads((tmp_path / f"{label}__2x16x16.json").read_text())
        assert rec["wire"] == "int16" and "memory_model" in rec
        if name == "WX-136B" and label in (f"{name}-mono", f"{name}-rest(t={t})"):
            assert rec["skipped_compile"].startswith("node ids exceed int32")
            assert rec["n"] + 1 >= 2**31
            continue
        assert "skipped_compile" not in rec, label
        assert rec["peak_temp_bytes"] > 0 and rec["roofline"]["collective_s"] > 0
        # The 2x16x16 mesh: the 16-rank slot groups span two NVLink nodes.
        assert set(rec["collectives"]["link_wire_bytes"]) == {"ib"}
        count = rec["collectives"]["count"]
        assert count["all-gather"] == 2 * (count["all-reduce"] - 1)


def test_cli_slices_table(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(port_kd, "ARTIFACT_DIR", str(tmp_path))
    port_kd.main(["--case", "com-friendster", "--slices", "4"])
    rec = json.loads((tmp_path / "com-friendster-slices4__16x16.json").read_text())
    assert rec["n_slices"] == 4 and len(rec["slice_loads"]) == 4
    assert "3-part split on 16x16 / 4 slices" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="must divide"):
        port_kd.main(["--case", "com-friendster", "--slices", "3"])
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------------------- #
# The tally against the live engine's counters
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("wire_dtype", [torch.int32, torch.int16])
def test_tally_collectives_equal_measured_sweep_bytes(wire_dtype):
    bg = bucketize(rmat(12, 8, seed=0))
    cand = 40
    with port_mesh.fake_process_group(4):
        plan = port_mesh.make_mesh_plan((2, 2))
        buckets = port_dist.shard_buckets(bg, plan, "meta")
        tally, _ = port_kd.traced_sweep(plan, cand, *_meta_state(bg.n_nodes, wire_dtype),
                                        buckets)
    assert not torch.distributed.is_initialized()
    nb = len(buckets)
    want = port_dist.measured_sweep_bytes(
        [b.rows for b in buckets], plan, cand, torch.tensor([], dtype=wire_dtype).element_size(),
        np.ones(nb, dtype=bool), frontier=True)
    assert tally.collectives.total_wire == want
    # Per bucket: the counts all-reduce and the estimate and ids
    # all-gathers; then the dirty-bit all-reduce.
    assert tally.collectives.count == {"all-reduce": nb + 1, "all-gather": 2 * nb}
    # The counts kernel's [rows, cand] output is written once per bucket.
    counts_bytes = sum(b.ids.shape[0] * cand * 4 for b in buckets)
    assert tally.write_bytes > counts_bytes and tally.peak_bytes > max(
        b.ids.shape[0] * cand * 4 for b in buckets)


# --------------------------------------------------------------------- #
# The data-independent dirty push
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("wire", ["int32", "int16"])
def test_dirty_push_matches_reference(wire):
    """Sweep by sweep from the start state, with a frontier that also drops
    buckets the reference would keep: the same estimates, changed counts
    and dirty bits as the reference's max-scatter."""
    from repro.core.hindex import hindex_of_sequence as ref_hseq
    import jax

    g = ref_rmat(10, 8, seed=3)
    bg = ref_bucketize(g)
    pbg = from_reference_arrays(bg)
    cand = max(1, ref_hseq(bg.degrees.astype(np.int64) + bg.ext))
    nb = len(bg.buckets)
    ref_plan = ref_dist.MeshPlan(mesh=jax.make_mesh((1, 1), ("data", "model")),
                                 node_axes=("data",), slot_axes=("model",))
    jdt, tdt = (jnp.int32, torch.int32) if wire == "int32" else (jnp.int16, torch.int16)
    ref_sweep = ref_dist.make_sweep_fn(ref_plan, cand, jdt)(nb)
    port_sweep = port_dist.make_sweep_fn(port_dist.MeshPlan(), cand)
    start = (bg.degrees.astype(np.int32) + bg.ext.astype(np.int32))
    c_np = np.concatenate([start, [-1]]).astype(np.int32)
    ext_np = np.concatenate([bg.ext, [0]]).astype(np.int32)
    tile_np = ref_dist.node_tile_map(bg)
    ref_c, ref_ext, ref_tile = jnp.asarray(c_np, jdt), jnp.asarray(ext_np), jnp.asarray(tile_np)
    ref_buckets = ref_dist.shard_buckets(bg, ref_plan, jdt)
    c = torch.from_numpy(c_np).to(tdt)
    ext, tile = torch.from_numpy(ext_np), torch.from_numpy(port_dist.node_tile_map(pbg))
    buckets = port_dist.shard_buckets(pbg, port_dist.MeshPlan(), "cpu")
    adj = bg.bucket_adjacency()
    active = np.ones(nb, dtype=bool)
    for it in range(60):
        ref_c, ref_changed, ref_dirty = ref_sweep(ref_c, ref_ext, jnp.asarray(active), ref_tile,
                                                  ref_buckets)
        changed, dirty = port_sweep(c, ext, active, tile, buckets)
        np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c))
        np.testing.assert_array_equal(changed.numpy(), np.asarray(ref_changed))
        np.testing.assert_array_equal(dirty.numpy(), np.asarray(ref_dirty))
        changed = changed.numpy()
        if changed.sum() == 0:
            break
        active = dirty.numpy() & adj[changed > 0].any(axis=0)
        if it % 3 == 1:  # also reach states the engine's frontier never picks
            active[it % nb] = False
    assert it > 2


# --------------------------------------------------------------------- #
# The tally's rules, on small meta programs
# --------------------------------------------------------------------- #
def test_tally_peak_counts_each_storage_once_until_freed():
    meta = torch.device("meta")
    outside = torch.empty(1000, dtype=torch.int32, device=meta)
    with Tally() as t:
        a = torch.zeros(100, dtype=torch.int32, device=meta)       # 400 B
        view = a[10:20].view(2, 5)                                  # a view: nothing
        a.add_(1)                                                   # in place: nothing
        outside.add_(1)                                             # made outside: nothing
        b = torch.zeros(50, dtype=torch.int64, device=meta)         # 400 B -> 800
        del a, view
        c = torch.zeros(25, dtype=torch.int32, device=meta)         # 100 B -> 500
        del b, c
    assert t.peak_bytes == 800


def test_tally_peak_holders():
    """With ``holders=True`` the tally keeps the storages live at the peak,
    each with the op and shape that made it; ``top_holders`` sums them."""
    meta = torch.device("meta")
    with Tally(holders=True) as t:
        a = torch.zeros(100, dtype=torch.int32, device=meta)       # 400 B
        b = torch.zeros(100, dtype=torch.int32, device=meta)       # 400 B -> 800
        c = torch.ones(50, dtype=torch.int64, device=meta)          # 400 B -> 1200, the peak
        del a, b
        d = torch.zeros(200, dtype=torch.int32, device=meta)       # 800 B -> 1200, no new peak
        del c, d
    assert t.peak_bytes == 1200
    assert t.peak_holders == [(400, "zeros", (100,), "int32"), (400, "zeros", (100,), "int32"),
                              (400, "ones", (50,), "int64")]
    assert top_holders(t.peak_holders, 1) == [(800, 2, "zeros", (100,), "int32")]
    with Tally() as t:
        e = torch.zeros(10, device=meta)
    assert t.peak_holders == [] and e.shape == (10,)


def test_tally_bytes_and_ops():
    meta = torch.device("meta")
    src = torch.empty(1 << 20, dtype=torch.int16, device=meta)
    idx = torch.empty(30, 8, dtype=torch.int32, device=meta)
    row = torch.empty(8, dtype=torch.int32, device=meta)
    with Tally() as t:
        g = src[idx]                       # gather: 240 ids + 240 int16 read, 240 int16 written
    assert (t.read_bytes, t.write_bytes, t.int_ops) == (240 * 4 + 240 * 2, 240 * 2, 0)
    x = torch.empty(30, 8, dtype=torch.int32, device=meta)
    with Tally() as t:
        y = x >= row                       # pointwise, row broadcast: read once
        s = y.sum()                        # reduction over 240 elements
    assert t.read_bytes == 240 * 4 + 8 * 4 + 240
    assert t.write_bytes == 240 + 8
    assert t.int_ops == 240 + 240
    dest = torch.zeros(1 << 20, dtype=torch.int32, device=meta)
    ids = torch.empty(64, dtype=torch.int64, device=meta)
    vals = torch.empty(64, dtype=torch.int32, device=meta)
    with Tally() as t:
        dest[ids] = vals                   # scatter: touches 64 slots, not the 4 MiB
        dest.scatter_reduce_(0, ids, vals, reduce="amax")
    assert t.write_bytes == 2 * 64 * 4 and t.read_bytes == 2 * 64 * (8 + 4)
    assert t.bytes_by_op == {"index_put_": 64 * 16, "scatter_reduce_": 64 * 16}
    del g, y, s


def test_record_kernel_charges_the_innermost_tally_of_this_thread():
    record_kernel("k", read_bytes=1, write_bytes=1, int_ops=1)  # no tally: nothing to charge
    with Tally() as outer:
        with Tally() as inner:
            record_kernel("k", read_bytes=10, write_bytes=20, int_ops=30)
        record_kernel("k", read_bytes=1, write_bytes=2, int_ops=3)
    assert (inner.read_bytes, inner.write_bytes, inner.int_ops) == (10, 20, 30)
    assert (outer.read_bytes, outer.write_bytes, outer.int_ops) == (1, 2, 3)
    assert inner.bytes_by_op == {"k": 30} and outer.bytes_by_op == {"k": 3}


def test_counts_op_meta_branch_is_a_shape_function():
    x = torch.randint(-1, 40, (50, 24), dtype=torch.int32)
    ext = torch.randint(0, 3, (50,), dtype=torch.int32)
    x_meta, ext_meta = x.to("meta"), ext.to("meta")
    launches = partial_counts_op.launches
    with Tally() as t:
        out = partial_counts_op(x_meta, ext_meta, cand=33)
    assert out.device.type == "meta" and out.shape == (50, 33) and out.dtype == torch.int32
    assert partial_counts_op.launches == launches  # a shape function launches nothing
    assert (t.read_bytes, t.write_bytes, t.int_ops) == (50 * 24 * 4 + 50 * 4, 50 * 33 * 4,
                                                       50 * 24)
    assert t.peak_bytes == 50 * 33 * 4
    with Tally() as t:  # the CPU path is the plain version, tallied op by op
        cpu = partial_counts_op(x, ext, cand=33)
    torch.testing.assert_close(cpu, partial_counts_plain(x, ext, cand=33), rtol=0, atol=0)
    assert t.int_ops > 50 * 24 * 33
    with pytest.raises(ValueError, match="meta"):
        partial_counts_op(x_meta, ext, cand=33)


# --------------------------------------------------------------------- #
# The ring formulas, the links and the production plan
# --------------------------------------------------------------------- #
_HLO = """HloModule m

ENTRY %main (p: s32[64]) -> s32[64] {{
  %p = s32[64]{{0}} parameter(0)
  %c = {shape} {kind}(s32[64]{{0}} %p), replica_groups=[{groups},{n}]<=[{total}]
}}
"""


@pytest.mark.parametrize("kind,shape,size", [
    ("all-gather", "s32[512]{0}", 2048),
    ("all-reduce", "s32[64]{0}", 256),
    ("reduce-scatter", "s32[8]{0}", 32),
    ("all-to-all", "s32[64]{0}", 256),
    ("collective-permute", "s32[64]{0}", 256),
])
@pytest.mark.parametrize("n", [2, 8, 16])
def test_ring_wire_bytes_match_reference(kind, shape, size, n):
    ref = parse_collectives(_HLO.format(shape=shape, kind=kind, groups=32 // n if n < 32 else 1,
                                        n=n, total=32))
    assert ref.count == {kind: 1}
    assert analysis.ring_wire_bytes(kind, size, n) == ref.wire_bytes[kind]
    stats = analysis.CollectiveStats()
    stats.add(kind, size, list(range(n)))
    assert stats.wire_bytes == ref.wire_bytes and stats.op_bytes == ref.op_bytes


def test_links_and_roofline_terms():
    assert analysis.link_of(range(8)) == "nvlink"
    assert analysis.link_of(range(8, 16)) == "nvlink"
    assert analysis.link_of(range(4, 12)) == "ib"
    assert analysis.link_of(range(0, 512, 16)) == "ib"
    stats = analysis.CollectiveStats()
    stats.add("all-reduce", 8000, range(8))        # 14,000 wire bytes on NVLink
    stats.add("all-gather", 16000, range(0, 32, 16))  # 8,000 on InfiniBand
    assert stats.link_wire_bytes == {"nvlink": 14000, "ib": 8000}
    rl = analysis.roofline_terms(1e9, 1e6, stats)
    assert rl.collective_s == pytest.approx(14000 / hw.NVLINK_BW + 8000 / hw.IB_BW)
    assert rl.compute_s == pytest.approx(1e9 / hw.PEAK_INT32_OPS)
    assert rl.memory_s == pytest.approx(1e6 / hw.HBM_BW)
    assert rl.bottleneck == "compute" and rl.wire_bytes_per_device == 22000


@pytest.mark.parametrize("multi_pod", [True, False])
def test_production_plan_on_a_fake_process_group(multi_pod):
    world = 512 if multi_pod else 256
    with port_mesh.fake_process_group(world):
        plan = port_mesh.make_production_plan(multi_pod=multi_pod)
        slot_ranks = torch.distributed.get_process_group_ranks(plan.slot_group)
        node_ranks = torch.distributed.get_process_group_ranks(plan.node_group)
        with pytest.raises(RuntimeError, match="already initialized"):
            with port_mesh.fake_process_group(world):
                pass
    assert not torch.distributed.is_initialized()
    assert plan.shape == ((2, 16, 16) if multi_pod else (16, 16))
    assert plan.axis_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
    assert (plan.n_node_shards, plan.n_slot_shards) == (world // 16, 16)
    assert (plan.rank, plan.node_index, plan.slot_index, plan.backend) == (0, 0, 0, "fake")
    assert slot_ranks == list(range(16)) and analysis.link_of(slot_ranks) == "ib"
    assert node_ranks == list(range(0, world, 16))
