"""The port's overlapped DC-kCore pipeline against the JAX package's.

* ``overlap=True`` is byte-identical to ``overlap=False`` and to the JAX
  ``dc_kcore(overlap=True)`` on the ba, rmat and er fixtures under Rough-
  and Exact-Divide, with the same per-part reports (timers aside), the same
  prefetch hits and misses and the same ``prefetched`` parts;
* Exact-Divide's speculation always hits;
* a ``prefetch``, ``boundary_fold`` or ``checkpoint_save`` crash from a
  ``FaultPlan`` drains every worker (no ``dckcore-prefetch`` or
  ``ckpt-save`` thread survives), leaves the last boundary on disk, and the
  run resumes to the uninterrupted coreness;
* a run crashed in one package with ``overlap`` on resumes in the other;
* the CLI's ``--overlap``, ``--fault`` and ``--fault-log`` on the CPU.
"""
import dataclasses
import functools
import json
import threading

import numpy as np
import pytest
import torch

from repro.core.dckcore import dc_kcore as ref_dc_kcore
from repro.graph.generators import rmat
from repro.graph.oracle import peel_coreness
from repro.runtime.fault import FaultPlan as RefFaultPlan
from repro.runtime.fault import FaultSpec as RefFaultSpec
from repro_torch.core.dckcore import PartReport, dc_kcore
from repro_torch.graph.structs import from_reference_arrays
from repro_torch.launch import kcore as port_cli
from repro_torch.runtime import FaultPlan, FaultSpec, InjectedFailure

torch.set_num_threads(1)

TIMERS = {"extract_time_s", "decompose_time_s", "save_time_s", "save_wall_s"}
WORKER_PREFIXES = ("dckcore-prefetch", "ckpt-save")
THRESHOLDS = (3, 8, 16)


@functools.lru_cache(maxsize=None)
def _small():
    return rmat(10, 8, seed=11)


@pytest.fixture(params=["er", "ba", "rmat"])
def fixture_graph(request, er_graph, ba_graph, rmat_graph):
    return {"er": er_graph, "ba": ba_graph, "rmat": rmat_graph}[request.param]


def _assert_reports_equal(ref_rep, rep):
    assert len(ref_rep.parts) == len(rep.parts)
    names = [f.name for f in dataclasses.fields(PartReport)]
    for a, b in zip(ref_rep.parts, rep.parts):
        for name in names:
            if name not in TIMERS:
                assert getattr(a, name) == getattr(b, name), name
    for field in ("overlap", "prefetch_hits", "prefetch_misses", "resumed_parts",
                  "total_comm", "total_iterations", "total_gathered_rows"):
        assert getattr(ref_rep, field) == getattr(rep, field), field


def _workers_alive():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(WORKER_PREFIXES) and t.is_alive()]


@pytest.mark.parametrize("strategy", ["rough", "exact"])
def test_overlap_matches_sequential_and_reference(fixture_graph, strategy):
    g = fixture_graph
    pg = from_reference_arrays(g)
    seq, rep_seq = dc_kcore(pg, THRESHOLDS, strategy=strategy, device="cpu")
    core, rep = dc_kcore(pg, THRESHOLDS, strategy=strategy, device="cpu", overlap=True)
    ref_core, ref_rep = ref_dc_kcore(g, THRESHOLDS, strategy=strategy, overlap=True)
    np.testing.assert_array_equal(core, seq)
    np.testing.assert_array_equal(core, ref_core)
    np.testing.assert_array_equal(core, peel_coreness(g))
    assert rep_seq.overlap is False and rep.overlap is True
    assert rep_seq.prefetch_hits == rep_seq.prefetch_misses == 0
    _assert_reports_equal(ref_rep, rep)
    # Every threshold part that ran submitted one speculation: a hit or a miss.
    ran = sum(1 for p in rep.parts if p.threshold is not None)
    assert rep.prefetch_hits + rep.prefetch_misses == ran
    if strategy == "exact":
        assert rep.prefetch_misses == 0 and rep.prefetch_hits >= 1
        assert not rep.parts[0].prefetched
        assert all(p.prefetched for p in rep.parts[1:])


@pytest.mark.parametrize("engine", ["fused", "kernel"])
def test_overlap_engines_and_empty_parts(engine):
    g = _small()
    kw = dict(strategy="exact", engine=engine, device="cpu")
    core, rep = dc_kcore(from_reference_arrays(g), (100, 4), overlap=True, **kw)
    seq, _ = dc_kcore(from_reference_arrays(g), (100, 4), **kw)
    np.testing.assert_array_equal(core, seq)
    np.testing.assert_array_equal(core, peel_coreness(g))
    core, rep = dc_kcore(from_reference_arrays(g), (), overlap=True, **kw)
    np.testing.assert_array_equal(core, seq)
    assert rep.prefetch_hits == rep.prefetch_misses == 0  # nothing to prefetch


@pytest.mark.parametrize("site,at", [("prefetch", 1), ("boundary_fold", 1),
                                     ("checkpoint_save", 1)])
def test_fault_drains_workers_then_resumes(site, at, tmp_path):
    g = _small()
    pg = from_reference_arrays(g)
    want, _ = dc_kcore(pg, THRESHOLDS, strategy="exact", device="cpu")
    plan = FaultPlan([FaultSpec(site, "crash", at=at)])
    ck = str(tmp_path / "ck")
    with pytest.raises(InjectedFailure, match=site):
        dc_kcore(pg, THRESHOLDS, strategy="exact", device="cpu", overlap=True,
                 checkpoint_dir=ck, fault_plan=plan)
    assert _workers_alive() == []
    assert [e["site"] for e in plan.events] == [site]
    # The same plan fires at the same visit in the JAX package.
    ref_plan = RefFaultPlan([RefFaultSpec(site, "crash", at=at)])
    with pytest.raises(Exception, match=site):
        ref_dc_kcore(g, THRESHOLDS, strategy="exact", overlap=True,
                     checkpoint_dir=str(tmp_path / "ref_ck"), fault_plan=ref_plan)
    assert plan.events == ref_plan.events
    core, rep = dc_kcore(pg, THRESHOLDS, strategy="exact", device="cpu", overlap=True,
                         checkpoint_dir=ck, resume=True)
    np.testing.assert_array_equal(core, want)
    assert rep.resumed_parts >= (site == "checkpoint_save")


def test_fault_slow_and_hang_sites():
    g = _small()
    pg = from_reference_arrays(g)
    want, _ = dc_kcore(pg, THRESHOLDS, device="cpu")
    plan = FaultPlan([FaultSpec("prefetch", "slow", at=0, count=2, delay_s=0.01),
                      FaultSpec("boundary_fold", "slow", at=0, count=10**9, delay_s=0.0)])
    core, rep = dc_kcore(pg, THRESHOLDS, device="cpu", overlap=True, fault_plan=plan)
    np.testing.assert_array_equal(core, want)
    assert plan.visits("prefetch") == sum(1 for p in rep.parts if p.threshold is not None)
    # A hang parks the worker until its delay ends, then raises: the main
    # thread joining the prefetch gets the failure, and nothing survives.
    hang = FaultPlan([FaultSpec("prefetch", "hang", delay_s=0.2)])
    with pytest.raises(InjectedFailure, match="hang at prefetch"):
        dc_kcore(pg, THRESHOLDS, device="cpu", overlap=True, fault_plan=hang)
    assert _workers_alive() == []


@pytest.mark.parametrize("crash_in", ["reference", "port"])
def test_resume_across_packages_with_overlap(crash_in, tmp_path):
    g = _small()
    pg = from_reference_arrays(g)
    ck = str(tmp_path / "ck")

    class Crash(Exception):
        pass

    def crash_after_part(i, _r):
        if i == 1:
            raise Crash

    kw = dict(strategy="rough", checkpoint_dir=ck, sweep_checkpoint_every=1,
              overlap=True)
    with pytest.raises(Crash):
        if crash_in == "reference":
            ref_dc_kcore(g, THRESHOLDS, on_part_done=crash_after_part, **kw)
        else:
            dc_kcore(pg, THRESHOLDS, device="cpu", on_part_done=crash_after_part, **kw)
    assert _workers_alive() == []
    if crash_in == "reference":
        core, rep = dc_kcore(pg, THRESHOLDS, device="cpu", resume=True, **kw)
    else:
        core, rep = ref_dc_kcore(g, THRESHOLDS, resume=True, **kw)
    ref_core, ref_rep = ref_dc_kcore(g, THRESHOLDS, strategy="rough", overlap=True)
    np.testing.assert_array_equal(core, ref_core)
    assert rep.resumed_parts == 2
    assert [p.name for p in rep.parts] == [p.name for p in ref_rep.parts]


def test_cli_overlap_fault_and_fault_log(tmp_path, capsys):
    argv = ["--graph", "rmat:9:8", "--thresholds", "8,4", "--engine", "fused",
            "--strategy", "exact", "--device", "cpu", "--overlap", "--check",
            "--checkpoint-dir", str(tmp_path / "ck")]
    port_cli.main(argv)
    out = capsys.readouterr().out
    assert "CONSISTENT" in out and "overlap=on" in out
    assert "prefetch: 2 hit(s), 0 miss(es)" in out
    log = tmp_path / "faults.json"
    port_cli.main(argv + ["--fault", "boundary_fold:slow:0:1:0.0",
                          "--fault-log", str(log)])
    events = json.loads(log.read_text())["events"]
    assert [(e["site"], e["kind"]) for e in events] == [("boundary_fold", "slow")]
    with pytest.raises(InjectedFailure):
        port_cli.main(argv + ["--fault", "checkpoint_save:crash:1"])
    with pytest.raises(SystemExit):
        port_cli.main(argv + ["--fault", "nowhere:crash"])
