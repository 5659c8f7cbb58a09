"""The port's serving layer against the JAX package's.

* ``SnapshotPublisher`` queries equal the peeling oracle; a snapshot is
  detached and read-only; the checksum is the JAX package's and flags a
  torn payload; readers hammering a republishing writer never see a torn
  or older snapshot; the metrics have the JAX package's shape.
* The serve CLI end to end on ``--device cpu``: the same batches, modes,
  publishes and final graph as the JAX CLI on the same edit log; a
  ``serve_update:crash`` is retried; a CUDA error is not retried and
  reaches the caller; without ``--device cpu`` it raises on a machine
  with no GPU.
* ``kernels.build.load`` builds and loads a library once when two threads
  ask for it first.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.core.snapshot_pub as ref_pub
from repro.graph.editlog import EditLog as RefEditLog
from repro.graph.generators import rmat
from repro.graph.oracle import peel_coreness, peel_kcore_mask
from repro.launch import kcore_serve as ref_serve
from repro_torch.core.snapshot_pub import CorenessSnapshot, SnapshotPublisher
from repro_torch.graph.editlog import EditLog
from repro_torch.graph.structs import from_reference_arrays
from repro_torch.kernels import build
from repro_torch.launch import kcore_serve

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served_graph():
    g = rmat(9, 8, seed=6)
    return from_reference_arrays(g), peel_coreness(g).astype(np.int32)


def test_queries_match_oracle(served_graph):
    g, core = served_graph
    pub = SnapshotPublisher()
    pub.publish(g, core)
    ids = np.random.default_rng(0).integers(-5, g.n_nodes + 5, 64)
    ok = (ids >= 0) & (ids < g.n_nodes)
    got = pub.query_coreness(ids)
    np.testing.assert_array_equal(got[ok], core[ids[ok]])
    assert not got[~ok].any()
    for k in (1, 2, int(core.max())):
        np.testing.assert_array_equal(pub.query_kcore_members(k),
                                      np.nonzero(peel_kcore_mask(g, k))[0])
        flags = pub.query_in_kcore(ids, k)
        np.testing.assert_array_equal(flags[ok], core[ids[ok]] >= k)
        assert not flags[~ok].any()
    k_max, top = pub.query_top_kcore()
    assert k_max == int(core.max())
    np.testing.assert_array_equal(top, np.nonzero(core >= k_max)[0])
    with pytest.raises(RuntimeError, match="no snapshot"):
        SnapshotPublisher().query_coreness([0])


def test_snapshot_checksum_and_torn_state(served_graph):
    g, core = served_graph
    scratch = core.copy()
    snap = SnapshotPublisher().publish(g, scratch)
    ref_snap = ref_pub.SnapshotPublisher().publish(g, core)
    assert (snap.version, snap.checksum) == (ref_snap.version, ref_snap.checksum)
    scratch[:] = -1  # the caller may reuse its buffer after publish
    np.testing.assert_array_equal(snap.coreness, core)
    with pytest.raises(ValueError):
        snap.coreness[0] = 7
    mixed = core.copy()
    mixed[0] += 1  # one element from "another version"
    torn = CorenessSnapshot(graph=g, coreness=mixed, version=snap.version,
                            checksum=snap.checksum, published_at=snap.published_at)
    assert snap.verify() and not torn.verify()


def test_swap_never_observes_torn_state(served_graph):
    g, core = served_graph
    pub = SnapshotPublisher()
    pub.publish(g, core)
    stop = threading.Event()
    failures = []

    def writer():
        rng = np.random.default_rng(1)
        for _ in range(200):
            pub.publish(g, core + rng.integers(0, 3, core.size).astype(np.int32), n_edits=1)
        stop.set()

    def reader(seed):
        rng = np.random.default_rng(seed)
        last = 0
        while not stop.is_set():
            snap = pub.snapshot
            if not snap.verify() or snap.version < last:
                failures.append(snap.version)
                return
            last = snap.version
            pub.query_coreness(rng.integers(0, g.n_nodes, 32))

    threads = [threading.Thread(target=writer, name="kcore-serve-test-w")]
    threads += [threading.Thread(target=reader, args=(s,), name="kcore-serve-test-r")
                for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not failures, failures
    m = pub.metrics()
    assert m["n_publishes"] == 201
    assert sorted(m) == sorted(ref_pub.SnapshotPublisher().metrics())


def _write_log(log_cls, workdir, n, n_batches, seed):
    rng = np.random.default_rng(seed)
    with log_cls(workdir) as log:
        for _ in range(n_batches):
            log.append(rng.integers(0, n, 3), rng.integers(0, n, 3))
            log.append(rng.integers(0, n, 1), rng.integers(0, n, 1), delete=True)
            log.seal_batch()
        return log.workdir


@pytest.mark.parametrize("engine", ["count", "fused"])
def test_serve_cli_matches_reference(engine, tmp_path):
    log = _write_log(RefEditLog, str(tmp_path / "log"), 256, 5, seed=5)
    argv = ["--graph", "rmat:8:4", "--edit-log", log, "--engine", engine,
            "--max-batches", "5", "--query-batch", "16", "--json"]
    m = kcore_serve.main(argv + ["--device", "cpu"])
    ref = ref_serve.main(["--graph", "rmat:8:4", "--edit-log", log, "--engine", "count",
                          "--max-batches", "5", "--query-batch", "16", "--json"])
    for key in ("batches_drained", "update_modes", "n_publishes", "n_edits_published",
                "pending_edits", "final_n_nodes", "final_k_max", "update_retries"):
        assert m[key] == ref[key], key
    assert m["n_queries"] > 0 and 0.0 <= m["query_p50_ms"] <= m["query_p99_ms"]
    assert m["device"] == "cpu"
    assert m["kernel_launches"] == {"fused_sweep": 0, "hindex": 0}  # plain versions


def test_serve_cli_retries_injected_crash(tmp_path, capsys):
    log = _write_log(EditLog, str(tmp_path / "log"), 256, 3, seed=2)
    m = kcore_serve.main(["--graph", "rmat:8:4", "--edit-log", log, "--device", "cpu",
                          "--max-batches", "3", "--update-backoff-s", "0.001",
                          "--fault", "serve_update:crash:1", "--json"])
    assert m["update_retries"] == 1 and m["batches_drained"] == 3
    assert "retry 1/3" in capsys.readouterr().out


def test_serve_cli_device_errors(tmp_path, monkeypatch):
    log = _write_log(EditLog, str(tmp_path / "log"), 256, 2, seed=3)
    calls = []

    def failing(*args, **kwargs):
        calls.append(kwargs["device"])
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(kcore_serve, "apply_updates", failing)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        kcore_serve.main(["--graph", "rmat:8:4", "--edit-log", log, "--device", "cpu",
                          "--update-backoff-s", "0.001"])
    assert len(calls) == 1  # not retried
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            kcore_serve.main(["--graph", "rmat:8:4", "--edit-log", log])


def test_build_load_is_thread_safe(tmp_path, monkeypatch):
    """Threads launching first: the build and the CDLL run once."""
    builds, loads = [], []
    lib = tmp_path / "libstub.so"

    def stub_build(names=None):
        builds.append(list(names))
        time.sleep(0.2)  # every thread is inside load() meanwhile
        lib.write_bytes(b"")
        return {n: 0.0 for n in names}

    def stub_cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "library_path", lambda name: lib)
    monkeypatch.setattr(build, "build", stub_build)
    monkeypatch.setattr(build.ctypes, "CDLL", stub_cdll)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.load("stub")))
               for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert builds == [["stub"]] and len(loads) == 1
    assert len(got) == 8 and all(lib_ is got[0] for lib_ in got)
