"""The port's streaming ingest (``repro_torch.graph.io``) against the JAX
package's, bit for bit.

* ``csr_from_edge_chunks`` / ``stream_edgelist`` / ``load_edgelist`` give
  the CSR and ``IngestStats`` of ``repro.graph.io`` at chunk sizes 1, 17
  and 10^6 on the adversarial streams of ``tests/test_stream_ingest.py``
  (self-loops, duplicates, both directions) and on the fixture graphs;
* ``EdgeStore.dup_degrees``, the store's cleanup, Rough-Divide and the
  induced subgraph straight from the store;
* the tracked transient bytes stay under the in-memory baseline and shrink
  with the chunk;
* npz and edge-list files written by one package load in the other;
* the CLI's ``file:`` / ``npz:`` graphs and ``--edge-chunk`` on the CPU.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro.graph.io as ref_io
from repro.core.divide import rough_candidates_from_store as ref_rough_from_store
from repro.graph.generators import erdos_renyi, rmat
from repro.graph.structs import Graph as RefGraph
from repro_torch.core.divide import rough_candidates_from_store
from repro_torch.graph import io
from repro_torch.graph.structs import Graph, from_reference_arrays
from repro_torch.launch import kcore as port_cli

torch.set_num_threads(1)


def _assert_graph_equal(a, b):
    assert a.n_nodes == b.n_nodes
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype and a.indices.dtype == b.indices.dtype


def _assert_stats_equal(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.baseline_transient_bytes == b.baseline_transient_bytes


def _adversarial_stream(seed):
    """The stream of tests/test_stream_ingest.py's adversarial test."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 50))
    m = int(rng.integers(0, 5 * n))
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    if m >= 4:
        src[0] = dst[0] = 0
        src[1], dst[1] = src[2], dst[2]
    return n, src, dst


@pytest.fixture(params=["er", "ba", "rmat"])
def fixture_graph(request, er_graph, ba_graph, rmat_graph):
    return {"er": er_graph, "ba": ba_graph, "rmat": rmat_graph}[request.param]


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("chunk", [1, 17, 10**6])
def test_chunked_build_matches_reference_adversarial(seed, chunk):
    n, src, dst = _adversarial_stream(seed)
    chunks = [(src[i:i + chunk], dst[i:i + chunk]) for i in range(0, src.size, chunk)]
    got, stats = io.csr_from_edge_chunks(iter(chunks), n_nodes=n, chunk_edges=chunk)
    want, ref_stats = ref_io.csr_from_edge_chunks(iter(chunks), n_nodes=n, chunk_edges=chunk)
    _assert_graph_equal(got, want)
    _assert_graph_equal(got, RefGraph.from_edges(src, dst, n_nodes=n))
    _assert_stats_equal(stats, ref_stats)


@pytest.mark.parametrize("chunk", [1, 17, 10**6])
def test_stream_edgelist_matches_reference(fixture_graph, tmp_path, chunk):
    # One edge a chunk on a short stream, as tests/test_stream_ingest.py does.
    g = erdos_renyi(60, 4.0, seed=5) if chunk == 1 else fixture_graph
    path = str(tmp_path / "edges.txt")
    ref_io.save_edgelist(path, g)
    with open(path) as f:
        body = f.read()
    with open(path, "w") as f:
        f.write("# SNAP-style comment\n\n" + body)
    got, stats = io.stream_edgelist(path, chunk_edges=chunk)
    want, ref_stats = ref_io.stream_edgelist(path, chunk_edges=chunk)
    _assert_graph_equal(got, want)
    _assert_graph_equal(got, ref_io.load_edgelist(path))
    _assert_graph_equal(io.load_edgelist(path), want)
    _assert_stats_equal(stats, ref_stats)
    assert stats.n_chunks == -(-g.n_edges // chunk)


def test_graph_edge_chunks_match_reference(rmat_graph):
    pg = from_reference_arrays(rmat_graph)
    for chunk in (64, 4096):
        got = list(io.graph_edge_chunks(pg, chunk))
        want = list(ref_io.graph_edge_chunks(rmat_graph, chunk))
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    rebuilt, _ = io.csr_from_edge_chunks(io.graph_edge_chunks(pg, 1024),
                                         n_nodes=pg.n_nodes, chunk_edges=1024)
    _assert_graph_equal(rebuilt, rmat_graph)


def test_edge_cases_match_reference():
    # from_edges infers n before dropping self-loops; so must both builders.
    src, dst = np.array([0, 1, 9]), np.array([1, 0, 9])
    _assert_graph_equal(io.csr_from_edge_chunks([(src, dst)])[0],
                        ref_io.csr_from_edge_chunks([(src, dst)])[0])
    _assert_graph_equal(io.csr_from_edge_chunks([], n_nodes=5)[0], Graph.empty(5))
    # An out-of-range id only in a self-loop loads; on a real edge it raises.
    _assert_graph_equal(io.csr_from_edge_chunks([(np.array([0, 9]), np.array([1, 9]))],
                                                n_nodes=5)[0],
                        RefGraph.from_edges(np.array([0, 9]), np.array([1, 9]), n_nodes=5))
    for bad in ([(np.array([0, 9]), np.array([1, 2]))], [(np.array([-1]), np.array([2]))]):
        with pytest.raises(ValueError, match="out of range"):
            io.csr_from_edge_chunks(bad, n_nodes=5)


def test_transient_bytes_bounded_by_chunk(rmat_graph):
    pg = from_reference_arrays(rmat_graph)
    peaks = {}
    for chunk in (1 << 10, 1 << 14):
        _, stats = io.csr_from_edge_chunks(io.graph_edge_chunks(pg, chunk),
                                           n_nodes=pg.n_nodes, chunk_edges=chunk)
        _, ref_stats = ref_io.csr_from_edge_chunks(
            ref_io.graph_edge_chunks(rmat_graph, chunk), n_nodes=rmat_graph.n_nodes,
            chunk_edges=chunk)
        _assert_stats_equal(stats, ref_stats)
        assert stats.peak_transient_bytes < stats.baseline_transient_bytes
        peaks[chunk] = stats.peak_transient_bytes
    assert peaks[1 << 10] < peaks[1 << 14]


def test_edge_store_degrees_divide_and_cleanup(rmat_graph, tmp_path):
    pg = from_reference_arrays(rmat_graph)
    n = pg.n_nodes
    ext = (np.arange(n) % 3).astype(np.int32)
    keep = rmat_graph.degrees >= 6
    with io.EdgeStore(workdir=str(tmp_path / "port")) as store, \
            ref_io.EdgeStore(workdir=str(tmp_path / "ref")) as ref_store:
        for src, dst in io.graph_edge_chunks(pg, 4096):
            store.append(src, dst)
            ref_store.append(src, dst)
        # Duplicates only raise the counts: dup_degrees is an upper bound.
        store.append(np.array([0, 0]), np.array([1, 1]))
        ref_store.append(np.array([0, 0]), np.array([1, 1]))
        dup = store.dup_degrees(n)
        np.testing.assert_array_equal(dup, ref_store.dup_degrees(n))
        assert (dup >= pg.degrees).all() and dup[0] == pg.degrees[0] + 2
        assert (store.max_id, store.max_slot_id, store.n_slots, store.n_pairs) == (
            ref_store.max_id, ref_store.max_slot_id, ref_store.n_slots, ref_store.n_pairs)
        for t in (4, 12):
            np.testing.assert_array_equal(rough_candidates_from_store(store, n, ext, t),
                                          ref_rough_from_store(ref_store, n, ext, t))
        sub, ids, stats = io.induced_subgraph_from_store(store, keep, n_nodes=n,
                                                         chunk_edges=512)
        ref_sub, ref_ids, ref_stats = ref_io.induced_subgraph_from_store(
            ref_store, keep, n_nodes=n, chunk_edges=512)
        _assert_graph_equal(sub, ref_sub)
        np.testing.assert_array_equal(ids, ref_ids)
        _assert_stats_equal(stats, ref_stats)
    assert os.path.isdir(tmp_path / "port")  # a given workdir is the caller's
    own = io.EdgeStore()
    own.append(np.array([0, 1]), np.array([1, 2]))
    own.cleanup()
    assert not os.path.exists(own.workdir)


def test_files_cross_packages(rmat_graph, tmp_path):
    pg = from_reference_arrays(rmat_graph)
    io.save_npz(str(tmp_path / "port.npz"), pg)
    ref_io.save_npz(str(tmp_path / "ref.npz"), rmat_graph)
    _assert_graph_equal(ref_io.load_npz(str(tmp_path / "port.npz")), rmat_graph)
    _assert_graph_equal(io.load_npz(str(tmp_path / "ref.npz")), rmat_graph)
    io.save_edgelist(str(tmp_path / "port.txt"), pg, chunk_edges=1000)
    ref_io.save_edgelist(str(tmp_path / "ref.txt"), rmat_graph)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    # An edge list drops trailing isolated nodes; both loaders agree on it.
    _assert_graph_equal(ref_io.load_edgelist(str(tmp_path / "port.txt")),
                        io.load_edgelist(str(tmp_path / "ref.txt")))


def test_cli_file_npz_and_edge_chunk(tmp_path, capsys):
    ref_g = rmat(9, 8, seed=0)
    txt, npz = tmp_path / "g.txt", tmp_path / "g.npz"
    ref_io.save_edgelist(str(txt), ref_g)
    ref_io.save_npz(str(npz), ref_g)
    from_text = ref_io.load_edgelist(str(txt))  # trailing isolated nodes dropped
    for spec, chunk, want in ((f"file:{txt}", None, from_text),
                              (f"file:{txt}", 300, from_text),
                              (f"npz:{npz}", None, ref_g),
                              (f"npz:{npz}", 700, ref_g),
                              ("rmat:9:8", 500, ref_g)):
        got, stats = port_cli.load_graph(spec, 0, edge_chunk=chunk)
        assert (stats is None) == (chunk is None)
        _assert_graph_equal(got, want)
        argv = ["--graph", spec, "--thresholds", "8,4", "--engine", "fused",
                "--device", "cpu", "--check"]
        port_cli.main(argv + (["--edge-chunk", str(chunk)] if chunk else []))
        out = capsys.readouterr().out
        assert "CONSISTENT" in out
        assert ("ingest (streamed" in out) == (chunk is not None)
    with pytest.raises(ValueError, match="unknown graph spec"):
        port_cli.load_graph("csv:x", 0)
