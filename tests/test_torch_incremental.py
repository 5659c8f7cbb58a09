"""The port's incremental maintenance against the JAX package's.

* ``apply_edge_deltas`` gives the JAX function's graph and effective edits;
* an edit log written by either package replays in the other, a torn
  trailing frame included;
* ``apply_updates`` with the port's ``count``, ``kernel`` and ``fused``
  engines (plain versions on the CPU) equals the JAX
  ``apply_updates(op="count")`` after every batch of the churn streams of
  ``tests/test_incremental.py`` -- unit and batch edits, insert-only,
  delete-only, node growth, the near-uniform coreness that falls back --
  in coreness, mode, dirty region and every per-sweep counter of the
  re-sweep (iterations, ``comm_per_iter``, ``active_rows_per_iter``); the
  port's kernels compute the exact h-index, as the ``count`` engine does;
* final coreness equals the JAX ``kernel`` and ``fused`` engines' too;
* the triangle-delete case and ``dirty_budget_frac=0`` forcing full mode.
"""
import numpy as np
import pytest
import torch

import repro.core.incremental as ref_inc
import repro.graph.delta as ref_delta
import repro.graph.editlog as ref_editlog
from repro.graph.generators import barabasi_albert, erdos_renyi, rmat
from repro.graph.oracle import peel_coreness
from repro.graph.structs import Graph as RefGraph
from repro_torch.core.incremental import apply_updates
from repro_torch.graph import delta, editlog
from repro_torch.graph.structs import from_reference_arrays

torch.set_num_threads(1)

PORT_OPS = ("count", "kernel", "fused")


def _assert_graph_equal(a, b):
    assert a.n_nodes == b.n_nodes
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype and a.indices.dtype == b.indices.dtype


def _random_batch(rng, g, n_ins, n_del):
    """tests/test_incremental.py::_random_batch: n_ins uniform node pairs,
    n_del deletes of existing edges (a node of nonzero degree, then a
    uniform neighbour). Returns the raw arrays."""
    n = g.n_nodes
    iu = rng.integers(0, n, n_ins)
    iv = rng.integers(0, n, n_ins)
    du, dv = [], []
    nz = np.nonzero(np.diff(g.indptr) > 0)[0]
    for _ in range(n_del):
        if nz.size == 0:
            break
        r = int(nz[rng.integers(0, nz.size)])
        du.append(r)
        dv.append(int(g.indices[rng.integers(g.indptr[r], g.indptr[r + 1])]))
    return iu, iv, np.asarray(du, np.int64), np.asarray(dv, np.int64)


def _assert_update_equal(ref, got):
    assert got.mode == ref.mode
    np.testing.assert_array_equal(got.coreness, ref.coreness)
    assert got.coreness.dtype == np.int32
    np.testing.assert_array_equal(got.dirty_mask, ref.dirty_mask)
    assert (got.dirty_count, got.dirty_frac, got.gathered_rows) == (
        ref.dirty_count, ref.dirty_frac, ref.gathered_rows)
    assert (got.n_inserted, got.n_deleted) == (ref.n_inserted, ref.n_deleted)
    _assert_graph_equal(got.graph, ref.graph)
    if ref.decompose_result is None:
        assert got.decompose_result is None
        return
    a, b = ref.decompose_result, got.decompose_result
    assert (b.iterations, b.comm_per_iter, b.active_rows_per_iter) == (
        a.iterations, a.comm_per_iter, a.active_rows_per_iter)
    assert set(got.stage_s) == {"splice", "region", "bucketize", "resweep"}


def _churn(g, batches, *, dirty_budget_frac=0.5):
    """Drive one edit stream through the JAX ``count`` engine and the port's
    three engines side by side, holding them equal after every batch."""
    ref_core = peel_coreness(g).astype(np.int32)
    state = {op: (from_reference_arrays(g), ref_core.copy()) for op in PORT_OPS}
    modes = {}
    for iu, iv, du, dv in batches(g):
        ref = ref_inc.apply_updates(g, ref_core, ref_delta.EdgeEdits.of(iu, iv, du, dv),
                                    op="count", dirty_budget_frac=dirty_budget_frac)
        for op in PORT_OPS:
            pg, pcore = state[op]
            got = apply_updates(pg, pcore, delta.EdgeEdits.of(iu, iv, du, dv), op=op,
                                dirty_budget_frac=dirty_budget_frac, device="cpu")
            _assert_update_equal(ref, got)
            state[op] = (got.graph, got.coreness)
        g, ref_core = ref.graph, ref.coreness
        modes[ref.mode] = modes.get(ref.mode, 0) + 1
    np.testing.assert_array_equal(ref_core, peel_coreness(g))
    return g, ref_core, modes


def _stream(seed, n_steps, batch_hi=1, fixed=None):
    """Batches drawn as tests/test_incremental.py's streams draw them:
    ``batch_hi`` edits a batch split at random between inserts and deletes,
    or ``fixed=(n_ins, n_del)`` a batch."""
    def batches(g):
        rng = np.random.default_rng(seed)
        for _ in range(n_steps):
            if fixed is None:
                k = int(rng.integers(1, batch_hi + 1))
                ins = int(rng.integers(0, k + 1))
                edits = _random_batch(rng, g, ins, k - ins)
            else:
                edits = _random_batch(rng, g, *fixed)
            yield edits
            g = ref_delta.apply_edge_deltas(g, ref_delta.EdgeEdits.of(*edits)).graph
    return batches


# --------------------------------------------------------------------- #
# CSR deltas and the edit log
# --------------------------------------------------------------------- #
def test_apply_edge_deltas_matches_reference():
    rng = np.random.default_rng(0)
    n = 60
    for _trial in range(25):
        m = int(rng.integers(0, 300))
        g = RefGraph.from_edges(rng.integers(0, n, m), rng.integers(0, n, m), n_nodes=n)
        mi, md = int(rng.integers(0, 40)), int(rng.integers(0, 40))
        # Inserts may reach past n: the graph grows.
        raw = (rng.integers(0, n + 5, mi), rng.integers(0, n, mi),
               rng.integers(0, n + 5, md), rng.integers(0, n, md))
        ref = ref_delta.apply_edge_deltas(g, ref_delta.EdgeEdits.of(*raw))
        got = delta.apply_edge_deltas(from_reference_arrays(g), delta.EdgeEdits.of(*raw))
        _assert_graph_equal(got.graph, ref.graph)
        for f in ("ins_u", "ins_v", "del_u", "del_v"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        assert got.rows_rebuilt == ref.rows_rebuilt
    g = RefGraph.from_edges(np.array([0]), np.array([1]), n_nodes=2)
    with pytest.raises(ValueError):
        delta.apply_edge_deltas(from_reference_arrays(g), delta.EdgeEdits.inserts([5], [1]),
                                n_nodes=3)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_edit_log_replays_across_packages(writer, tmp_path):
    write_mod, read_mod = ((ref_editlog, editlog) if writer == "reference"
                           else (editlog, ref_editlog))
    with write_mod.EditLog(str(tmp_path / "log")) as log:
        log.append([0, 5, 5], [5, 0, 5])            # duplicate + self-loop
        log.append([1], [2], delete=True)
        log.seal_batch()
        log.append([7, 3], [8, 9])
        log.seal_batch()
        log.seal_batch()                            # an empty batch is legal
        log.append([4], [6])                        # open batch: not sealed
        # A half-written trailing frame (one int64 of two) is not sealed.
        with open(log.frames_path, "ab") as f:
            np.array([99], dtype=np.int64).tofile(f)
        a, b = read_mod.EditLogReader(log.workdir), write_mod.EditLogReader(log.workdir)
        assert a.poll() == b.poll() == 3
        for chunk in (1, 1 << 20, 1 << 20):
            x, y = a.read_batch(chunk_slots=chunk), b.read_batch()
            for f in ("ins_src", "ins_dst", "del_src", "del_dst"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        assert a.read_batch() is None and a.poll() == 0


# --------------------------------------------------------------------- #
# apply_updates, batch by batch
# --------------------------------------------------------------------- #
CHURN_STREAMS = {  # name: (graph, batches, incremental batches at least)
    "unit_edits": (lambda: rmat(10, 8, seed=7), _stream(11, 12), 8),
    "batch_edits": (lambda: rmat(10, 8, seed=3), _stream(13, 8, batch_hi=4), 1),
    "er": (lambda: erdos_renyi(400, 6.0, seed=3), _stream(5, 6, batch_hi=2), 0),
    "insert_only": (lambda: rmat(9, 8, seed=8), _stream(4, 5, fixed=(2, 0)), 1),
    "delete_only": (lambda: rmat(9, 8, seed=8), _stream(4, 5, fixed=(0, 2)), 1),
}


@pytest.mark.parametrize("name", list(CHURN_STREAMS))
def test_churn_matches_reference_count_engine(name):
    graph, batches, min_incremental = CHURN_STREAMS[name]
    _g, _core, modes = _churn(graph(), batches)
    assert modes.get("incremental", 0) >= min_incremental, modes


def test_uniform_coreness_falls_back_to_full():
    # BA graphs have near-uniform coreness: the equal-coreness subcore is the
    # whole graph, so updates fall back to the full re-sweep.
    _g, _core, modes = _churn(barabasi_albert(600, 4, seed=7), _stream(9, 4))
    assert modes.get("full", 0) >= 1, modes


def test_node_growth_and_noop():
    def batches(_g):
        yield [2, 3, 4], [3, 4, 5], [], []      # new trailing nodes 3, 4, 5
        yield [0], [1], [], []                  # already present: a noop
        yield [5, 9], [9, 2], [0], [1]          # grow again, with a delete
    g = RefGraph.from_edges(np.array([0, 1]), np.array([1, 2]), n_nodes=3)
    g, core, modes = _churn(g, batches, dirty_budget_frac=1.0)
    assert g.n_nodes == 10 and modes["noop"] == 1


def test_final_coreness_matches_every_reference_engine():
    """The JAX ``kernel`` and ``fused`` engines skip candidate chunks above
    a tile's largest estimate; on these re-sweep states they take the
    ``count`` engine's trajectory, which the port's exact kernels take, and
    reach the same coreness."""
    g = rmat(9, 6, seed=5)
    batches = list(_stream(17, 4, batch_hi=3)(g))
    cores, trajectories = {}, {}
    for op in ("count", "kernel", "fused"):
        gg, core = g, peel_coreness(g).astype(np.int32)
        pg, pcore = from_reference_arrays(g), core.copy()
        for edits in batches:
            res = ref_inc.apply_updates(gg, core, ref_delta.EdgeEdits.of(*edits), op=op)
            gg, core = res.graph, res.coreness
            got = apply_updates(pg, pcore, delta.EdgeEdits.of(*edits), op=op, device="cpu")
            pg, pcore = got.graph, got.coreness
            for name, r in (("ref", res), ("port", got)):
                d = r.decompose_result
                trajectories.setdefault((name, op), []).append(
                    (r.mode, d.comm_per_iter if d else None))
        cores[op] = (core, pcore)
    for op, (ref_core, port_core) in cores.items():
        np.testing.assert_array_equal(port_core, ref_core, err_msg=op)
        np.testing.assert_array_equal(port_core, cores["count"][0], err_msg=op)
        for name in ("ref", "port"):
            assert trajectories[name, op] == trajectories["ref", "count"], (name, op)


def test_triangle_delete_third_corner_must_fall():
    g = RefGraph.from_edges(np.array([0, 1, 2]), np.array([1, 2, 0]), n_nodes=3)
    core = peel_coreness(g)
    for op in PORT_OPS:
        res = apply_updates(from_reference_arrays(g), core, delta.EdgeEdits.deletes([0], [1]),
                            op=op, dirty_budget_frac=1.0, device="cpu")
        assert res.mode == "incremental"
        assert res.coreness.tolist() == [1, 1, 1]
        assert bool(res.dirty_mask[2]), "third corner must be in the fall region"


def test_budget_zero_forces_full_mode():
    g = rmat(9, 6, seed=2)
    core = peel_coreness(g)
    v = next(x for x in range(1, g.n_nodes) if x not in set(g.neighbors(0).tolist()))
    ref = ref_inc.apply_updates(g, core, ref_delta.EdgeEdits.inserts([0], [v]),
                                op="count", dirty_budget_frac=0.0)
    for op in PORT_OPS:
        got = apply_updates(from_reference_arrays(g), core, delta.EdgeEdits.inserts([0], [v]),
                            op=op, dirty_budget_frac=0.0, device="cpu")
        assert got.mode == "full" and bool(got.dirty_mask.all())
        _assert_update_equal(ref, got)
    with pytest.raises(ValueError, match="coreness shape"):
        apply_updates(from_reference_arrays(g), np.zeros(3, np.int32), delta.EdgeEdits.of(),
                      device="cpu")


def test_default_device_never_falls_back():
    g = from_reference_arrays(rmat(6, 4, seed=0))
    core = np.zeros(g.n_nodes, np.int32)
    if torch.cuda.is_available():
        assert apply_updates(g, core, delta.EdgeEdits.of()).mode == "noop"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            apply_updates(g, core, delta.EdgeEdits.of())
