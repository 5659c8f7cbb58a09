"""The port's graph substrate against the JAX package's, bit for bit.

``repro_torch.graph`` and ``repro_torch.core.divide`` are numpy copies of
the JAX package's modules; these tests hold them byte-identical on the
shared fixtures (CSR, bucketize tiles, reorder permutations, bucket
adjacency, the divide passes and the oracle), and check that the port
imports neither JAX nor the ``repro`` package.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.divide as ref_divide
import repro.graph.build as ref_build
import repro.graph.generators as ref_gen
import repro.graph.oracle as ref_oracle
import repro.graph.reorder as ref_reorder
import repro.graph.structs as ref_structs
import repro_torch.core.divide as port_divide
import repro_torch.graph.build as port_build
import repro_torch.graph.generators as port_gen
import repro_torch.graph.oracle as port_oracle
import repro_torch.graph.reorder as port_reorder
import repro_torch.graph.structs as port_structs

SRC = Path(__file__).resolve().parents[1] / "src"


def _port_graph(ref_g):
    return port_structs.from_reference_arrays(ref_g)


def _assert_graph_equal(a, b):
    assert a.n_nodes == b.n_nodes
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype and a.indices.dtype == b.indices.dtype
    for f in ("perm", "inv_perm"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


def _assert_bucketed_equal(a, b):
    assert a.n_nodes == b.n_nodes and len(a.buckets) == len(b.buckets)
    for ba, bb in zip(a.buckets, b.buckets):
        assert ba.width == bb.width
        for f in ("node_ids", "neigh", "deg"):
            x, y = getattr(ba, f), getattr(bb, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for f in ("ext", "degrees", "bucket_adj", "node_bucket", "perm", "inv_perm"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.bucket_adjacency(), b.bucket_adjacency())
    np.testing.assert_array_equal(a.node_bucket_map(), b.node_bucket_map())
    assert a.memory_bytes() == b.memory_bytes()
    assert a.rows_per_full_sweep == b.rows_per_full_sweep
    assert a.padded_slots == b.padded_slots


@pytest.fixture(scope="module", params=["er", "ba", "rmat"])
def fixture_graph(request, er_graph, ba_graph, rmat_graph):
    return {"er": er_graph, "ba": ba_graph, "rmat": rmat_graph}[request.param]


# --------------------------------------------------------------------- #
# Import hygiene
# --------------------------------------------------------------------- #
def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module imports in a fresh interpreter without
    pulling in JAX, any module of the JAX package, or ``ml_dtypes`` (the
    JAX package's checkpoints need it; the card's machine has none)."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'jaxlib' or k == 'repro' or k.startswith('repro.')\n"
        "             or k == 'ml_dtypes' or k.startswith('ml_dtypes.'))\n"
        "for m in ('repro_torch.ckpt.checkpoint', 'repro_torch.core.distributed',\n"
        "          'repro_torch.kernels.counts.ops', 'repro_torch.launch.mesh',\n"
        "          'repro_torch.graph.io', 'repro_torch.graph.delta',\n"
        "          'repro_torch.graph.editlog', 'repro_torch.runtime.fault',\n"
        "          'repro_torch.core.incremental', 'repro_torch.core.snapshot_pub',\n"
        "          'repro_torch.launch.kcore_serve'):\n"
        "    assert m in sys.modules, m\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every module was imported


# --------------------------------------------------------------------- #
# Generators, CSR, oracle
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("spec", [
    ("erdos_renyi", dict(n=1500, avg_deg=8.0, seed=3)),
    ("barabasi_albert", dict(n=2000, m=5, seed=7)),
    ("rmat", dict(scale=11, edge_factor=8, seed=7)),
    ("rmat", dict(scale=9, edge_factor=16, seed=0)),
])
def test_generators_bit_identical(spec):
    name, kw = spec
    _assert_graph_equal(getattr(port_gen, name)(**kw), getattr(ref_gen, name)(**kw))


def test_from_edges_bit_identical():
    rng = np.random.default_rng(1)
    src = rng.integers(0, 300, 2000)
    dst = rng.integers(0, 300, 2000)
    _assert_graph_equal(port_structs.Graph.from_edges(src, dst, n_nodes=310),
                        ref_structs.Graph.from_edges(src, dst, n_nodes=310))


def test_oracle_bit_identical(fixture_graph):
    g = fixture_graph
    np.testing.assert_array_equal(port_oracle.peel_coreness(_port_graph(g)),
                                  ref_oracle.peel_coreness(g))
    for k in (2, 4, 8):
        np.testing.assert_array_equal(port_oracle.peel_kcore_mask(_port_graph(g), k),
                                      ref_oracle.peel_kcore_mask(g, k))


# --------------------------------------------------------------------- #
# bucketize tiles, adjacency, reorder
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("max_bucket_rows", ["auto", None, 16, 1])
def test_bucketize_bit_identical(fixture_graph, max_bucket_rows):
    g = fixture_graph
    ext = (np.arange(g.n_nodes) % 3).astype(np.int32)
    _assert_bucketed_equal(
        port_build.bucketize(_port_graph(g), ext=ext, max_bucket_rows=max_bucket_rows),
        ref_build.bucketize(g, ext=ext, max_bucket_rows=max_bucket_rows),
    )
    assert port_build.autotune_tile_caps(_port_graph(g)) == ref_build.autotune_tile_caps(g)


@pytest.mark.parametrize("method,sample_edges", [
    ("identity", None), ("bfs", None), ("rcm", None), ("bfs", 4096), ("rcm", 4096),
])
def test_reorder_bit_identical(fixture_graph, method, sample_edges):
    g = fixture_graph
    pg = port_reorder.reorder_graph(_port_graph(g), method, sample_edges=sample_edges)
    rg = ref_reorder.reorder_graph(g, method, sample_edges=sample_edges)
    _assert_graph_equal(pg, rg)
    ext = (np.arange(g.n_nodes) % 2).astype(np.int32)
    pb, rb = port_build.bucketize(pg, ext=ext), ref_build.bucketize(rg, ext=ext)
    _assert_bucketed_equal(pb, rb)
    assert port_reorder.bitmap_density(pb) == ref_reorder.bitmap_density(rb)
    np.testing.assert_array_equal(port_reorder.neighbor_spans(pg),
                                  ref_reorder.neighbor_spans(rg))


def test_from_reference_arrays_shares_the_arrays(rmat_graph):
    bg = ref_build.bucketize(rmat_graph)
    pb = port_structs.from_reference_arrays(bg)
    assert isinstance(pb, port_structs.BucketedGraph)
    _assert_bucketed_equal(pb, bg)
    pg = port_structs.from_reference_arrays(rmat_graph)
    assert isinstance(pg, port_structs.Graph)
    assert pg.indices is rmat_graph.indices


# --------------------------------------------------------------------- #
# Divide passes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("chunk", [None, 97, 4096])
def test_induced_subgraph_and_external_info(fixture_graph, chunk):
    g = fixture_graph
    rng = np.random.default_rng(chunk or 0)
    keep = rng.random(g.n_nodes) < 0.6
    upper = ~keep & (rng.random(g.n_nodes) < 0.5)
    ps, rs = (port_build.DivideStats(chunk_slots=chunk or 1 << 22),
              ref_build.DivideStats(chunk_slots=chunk or 1 << 22))
    psub, pids = port_build.induced_subgraph(_port_graph(g), keep, chunk_slots=chunk, stats=ps)
    rsub, rids = ref_build.induced_subgraph(g, keep, chunk_slots=chunk, stats=rs)
    _assert_graph_equal(psub, rsub)
    np.testing.assert_array_equal(pids, rids)
    np.testing.assert_array_equal(
        port_build.external_info(_port_graph(g), keep, upper, chunk_slots=chunk, stats=ps),
        ref_build.external_info(g, keep, upper, chunk_slots=chunk, stats=rs))
    assert vars(ps) == vars(rs)


@pytest.mark.parametrize("t", [2, 5, 9])
def test_divide_candidates_bit_identical(fixture_graph, t):
    g = fixture_graph
    ext = (np.arange(g.n_nodes) % 4).astype(np.int32)
    np.testing.assert_array_equal(
        port_divide.rough_candidates(g.degrees, ext, t),
        ref_divide.rough_candidates(g.degrees, ext, t))
    np.testing.assert_array_equal(
        port_divide.exact_candidates(_port_graph(g), ext, t, chunk_slots=512),
        ref_divide.exact_candidates(g, ext, t, chunk_slots=512))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_divide_passes_on_a_device_equal_the_host_passes(fixture_graph, seed):
    """The divide passes as torch ops (here on the CPU device) give the
    host passes' arrays, and count the same slots."""
    g = _port_graph(fixture_graph)
    rng = np.random.default_rng(seed)
    keep = rng.random(g.n_nodes) < 0.6
    upper = ~keep & (rng.random(g.n_nodes) < 0.5)
    host, dev = (port_build.DivideStats(chunk_slots=1 << 22) for _ in range(2))
    hsub, hids = port_build.induced_subgraph(g, keep, stats=host)
    dsub, dids = port_build.induced_subgraph(g, keep, stats=dev, device="cpu")
    _assert_graph_equal(dsub, hsub)
    assert dsub.indptr.dtype == np.int64 and dsub.indices.dtype == np.int32
    np.testing.assert_array_equal(dids, hids)
    got = port_build.external_info(g, keep, upper, stats=dev, device="cpu")
    np.testing.assert_array_equal(got, port_build.external_info(g, keep, upper, stats=host))
    assert got.dtype == np.int32
    assert (dev.input_slots, dev.kept_slots) == (host.input_slots, host.kept_slots)
    assert dev.peak_transient_bytes == 0
    ext = rng.integers(0, 4, g.n_nodes).astype(np.int32)
    for t in (2, 5, 9):
        np.testing.assert_array_equal(
            port_divide.exact_candidates(g, ext, t, device="cpu"),
            port_divide.exact_candidates(g, ext, t))


@pytest.mark.parametrize("budget", [1 << 10, 1 << 14, 1 << 17, 1 << 30])
def test_plan_thresholds_bit_identical(fixture_graph, budget):
    g = fixture_graph
    assert (port_divide.plan_thresholds(_port_graph(g), budget)
            == ref_divide.plan_thresholds(g, budget))
