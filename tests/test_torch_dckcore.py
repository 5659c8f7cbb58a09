"""The port's DC-kCore pipeline and CLI against the JAX package's.

``dc_kcore`` under Rough- and Exact-Divide, with thresholds and
monolithic, with and without RCM reordering: coreness and every per-part
report field other than the timers must equal the reference's. The port's
CLI on the CPU must pass its own oracle check.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core.dckcore import dc_kcore as ref_dc_kcore
from repro.graph.generators import rmat
from repro.graph.oracle import peel_coreness
from repro_torch.core.dckcore import PartReport, dc_kcore
from repro_torch.graph.structs import from_reference_arrays
from repro_torch.launch import kcore as port_cli
from repro_torch.runtime import FaultPlan

# The graphs here are small and pytest-xdist runs several workers side by
# side: one intra-op thread per worker keeps them from contending for cores.
torch.set_num_threads(1)

TIMERS = {"extract_time_s", "decompose_time_s", "save_time_s", "save_wall_s"}


@functools.lru_cache(maxsize=None)
def _graph(scale):
    return rmat(scale, 8, seed=7)


def _assert_reports_equal(ref_rep, port_rep):
    assert len(ref_rep.parts) == len(port_rep.parts)
    names = [f.name for f in dataclasses.fields(ref_rep.parts[0])]
    assert names == [f.name for f in dataclasses.fields(PartReport)]
    for a, b in zip(ref_rep.parts, port_rep.parts):
        for name in names:
            if name not in TIMERS:
                assert getattr(a, name) == getattr(b, name), name
    for prop in ("total_comm", "peak_bytes", "total_iterations",
                 "total_gathered_rows", "total_full_sweep_rows",
                 "total_collective_bytes"):
        assert getattr(ref_rep, prop) == getattr(port_rep, prop), prop


def _both(g, **kw):
    ref_core, ref_rep = ref_dc_kcore(g, **kw)
    core, rep = dc_kcore(from_reference_arrays(g), device="cpu", **kw)
    return ref_core, ref_rep, core, rep


@pytest.mark.parametrize("strategy", ["rough", "exact"])
@pytest.mark.parametrize("thresholds", [(), (8,), (16, 4)])
@pytest.mark.parametrize("reorder", ["identity", "rcm"])
def test_dc_kcore_matches_reference(strategy, thresholds, reorder):
    g = _graph(10)
    ref_core, ref_rep, core, rep = _both(
        g, thresholds=thresholds, strategy=strategy, reorder=reorder)
    np.testing.assert_array_equal(core, ref_core)
    np.testing.assert_array_equal(core, peel_coreness(g))
    _assert_reports_equal(ref_rep, rep)


@pytest.mark.parametrize("engine,int16", [("count", False), ("kernel", False),
                                          ("fused", False), ("fused", True)])
def test_dc_kcore_engines_match_reference(engine, int16):
    g = _graph(10)
    ref_core, ref_rep, core, rep = _both(
        g, thresholds=(8,), engine=engine, int16=int16, divide_chunk=256)
    np.testing.assert_array_equal(core, ref_core)
    _assert_reports_equal(ref_rep, rep)


def test_dc_kcore_tile_policy_and_part_hook():
    g = _graph(10)
    seen = []
    ref_core, ref_rep = ref_dc_kcore(g, thresholds=(6,), max_bucket_rows=None)
    core, rep = dc_kcore(from_reference_arrays(g), thresholds=(6,), max_bucket_rows=None,
                         device="cpu", on_part_done=lambda i, r: seen.append((i, r.name)))
    np.testing.assert_array_equal(core, ref_core)
    _assert_reports_equal(ref_rep, rep)
    assert seen == [(0, "core>=6"), (1, "rest")]


@pytest.mark.parametrize("option", [
    dict(part_parallel_plan=object()), dict(slice_capacity_bytes=1 << 20),
    dict(overlap=True, part_parallel=2), dict(part_parallel=2),
    dict(slice_timeout_s=1.0), dict(max_retries=1),
    dict(fault_plan=FaultPlan(), max_retries=1),
])
def test_later_slice_options_raise(option):
    """Part-parallel conquer and its watchdog are ported: alone and beside
    ``overlap`` and ``fault_plan`` each option raises the reference's error
    with the reference's message, or runs to the reference's coreness where
    the reference runs (``part_parallel=2``; a slice capacity alone, which
    the sequential path does not read)."""
    g = rmat(6, 4, seed=0)
    try:
        want, _ = ref_dc_kcore(g, **option)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            dc_kcore(from_reference_arrays(g), device="cpu", **option)
        assert str(got.value) == str(exc)
        return
    core, _ = dc_kcore(from_reference_arrays(g), device="cpu", **option)
    np.testing.assert_array_equal(core, want)


@pytest.mark.parametrize("strategy", ["rough", "exact"])
@pytest.mark.parametrize("thresholds", [(8,), (16, 4), (40,)])
def test_divide_on_a_device_matches_reference(strategy, thresholds):
    """The divide passes as torch ops give the reference's coreness and
    reports; only the host transient bytes, which they do not hold, read 0."""
    g = _graph(10)
    ref_core, ref_rep = ref_dc_kcore(g, thresholds=thresholds, strategy=strategy)
    core, rep = dc_kcore(from_reference_arrays(g), thresholds, strategy=strategy,
                         device="cpu", divide_device="cpu")
    np.testing.assert_array_equal(core, ref_core)
    for part in rep.parts:
        assert part.divide_transient_bytes == 0
    for part in ref_rep.parts:
        part.divide_transient_bytes = 0
    _assert_reports_equal(ref_rep, rep)


@pytest.mark.parametrize("option", [dict(overlap=True), dict(part_parallel=2)])
def test_divide_on_a_device_refuses_worker_threads(option):
    g = from_reference_arrays(rmat(6, 4, seed=0))
    with pytest.raises(ValueError, match="divide_device"):
        dc_kcore(g, (4,), device="cpu", divide_device="cpu", **option)


def test_custom_engine_conflicts():
    g = from_reference_arrays(rmat(6, 4, seed=0))
    with pytest.raises(ValueError, match="decompose_fn"):
        dc_kcore(g, engine="fused", decompose_fn=lambda bg: None)
    with pytest.raises(ValueError, match="decompose_fn"):
        dc_kcore(g, device="cpu", decompose_fn=lambda bg: None)


def test_default_device_never_falls_back():
    g = from_reference_arrays(rmat(6, 4, seed=0))
    if torch.cuda.is_available():
        dc_kcore(g, engine="fused")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dc_kcore(g, engine="fused")


@pytest.mark.parametrize("argv", [
    ["--graph", "rmat:9:8", "--engine", "fused", "--thresholds", "8,4"],
    ["--graph", "er:600:6", "--engine", "kernel", "--strategy", "exact",
     "--thresholds", "4"],
    ["--graph", "ba:500:3", "--engine", "fused", "--int16", "--reorder", "rcm"],
    ["--graph", "rmat:9:8", "--budget-gb", "0.00002"],
])
def test_cli_cpu_check_consistent(argv, capsys):
    port_cli.main(argv + ["--device", "cpu", "--check"])
    out = capsys.readouterr().out
    assert "CONSISTENT" in out
    assert "kernel launches: fused_sweep=0 hindex=0" in out


def test_cli_rejects_unported_graph_sources():
    """``file:`` and ``npz:`` graphs are ported (tests/test_torch_ingest.py);
    a missing file and an unknown spec still fail loudly."""
    with pytest.raises(FileNotFoundError):
        port_cli.load_graph("file:/nonexistent", 0)
    with pytest.raises(FileNotFoundError):
        port_cli.load_graph("npz:/nonexistent.npz", 0)
    with pytest.raises(ValueError, match="unknown graph spec"):
        port_cli.load_graph("parquet:/x", 0)
