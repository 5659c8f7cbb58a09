"""The port's spans (``repro_torch.trace``): recorded only while a torch
profiler records, as host events nested by call, and without effect on what
``decompose`` returns.

Spans are read as the benchmark reads them, from the profiler's event list
(``kineto_results.events()``): name, start, end and thread.
"""
import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core.dckcore import dc_kcore
from repro_torch.core.decompose import decompose
from repro_torch.graph import bucketize
from repro_torch.graph.generators import rmat
from repro_torch.graph.oracle import peel_coreness

torch.set_num_threads(1)

CALL_CHILDREN = ("repro_torch.decompose.guard", "repro_torch.decompose.start",
                 "repro_torch.decompose.cand", "repro_torch.decompose.tiles",
                 "repro_torch.decompose.result")
BUCKETIZE_CHILDREN = ("repro_torch.bucketize.caps", "repro_torch.bucketize.tiles",
                      "repro_torch.bucketize.adjacency")
# dc_kcore's own spans, and the divide passes' spans inside them.
DCKCORE_CHILDREN = ("repro_torch.dckcore.divide", "repro_torch.dckcore.layout",
                    "repro_torch.dckcore.conquer", "repro_torch.dckcore.merge",
                    "repro_torch.dckcore.shrink")
DIVIDE_SPANS = ("repro_torch.divide.exact", "repro_torch.divide.induce",
                "repro_torch.divide.external")
# (engine settings) of the decompose cases: both sweep functions, both
# fused dispatches, int16 behind its guard.
CASES = {
    "sorted": dict(op="sorted"),
    "fused-cond": dict(op="fused", fused_compaction_min_tiles=10**9),
    "fused-compaction": dict(op="fused", fused_compaction_min_tiles=1),
    "fused-int16": dict(op="fused", int16=True),
}


@functools.lru_cache(maxsize=None)
def _part():
    return bucketize(rmat(10, 8, seed=7))


def _spans(prof, prefix="repro_torch."):
    """``(name, start_ns, end_ns, thread)`` of the profile's host events
    named ``prefix*``, by start."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(prefix)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2] and child[3] == parent[3]


def _assert_same(a, b):
    """Two results equal in every field but ``wall_time_s``."""
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    for f in (fa, fb):
        f.pop("wall_time_s")
    np.testing.assert_array_equal(fa.pop("coreness"), fb.pop("coreness"))
    assert fa == fb


def test_span_is_the_shared_no_op_without_a_profiler():
    """No profiler records: every span is the one shared no-op, so nothing
    is recorded and nothing is allocated a span."""
    assert not torch.autograd._profiler_enabled()
    assert trace.span("repro_torch.x") is trace.span("repro_torch.y")
    with trace.span("repro_torch.x") as entered:
        assert entered is None


def test_span_is_a_host_event_of_the_profiler():
    """The private torch APIs the spans rest on: the profiler's enabled
    flag, and a function-scope record that the profiler keeps as a host
    event and does not take for a user annotation (which it would mirror
    onto the device's timeline)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd._profiler_enabled()
        with trace.span("repro_torch.outer"):
            with trace.span("repro_torch.inner"):
                torch.ones(4).sum()
    assert not torch.autograd._profiler_enabled()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("repro_torch.")}
    assert set(events) == {"repro_torch.outer", "repro_torch.inner"}
    for e in events.values():
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation()
    outer, inner = events["repro_torch.outer"], events["repro_torch.inner"]
    assert outer.start_ns() <= inner.start_ns() <= inner.end_ns() <= outer.end_ns()


@pytest.mark.parametrize("case", sorted(CASES))
def test_decompose_records_its_spans_nested_by_call(case):
    """Under a CPU profiler one decomposition records one root span, its
    five call-level children once each, one sweep span a sweep (as many as
    ``iterations``), each with one ``.launch`` and one ``.wait`` inside it,
    all inside the root on one thread; the result equals the unprofiled
    call's, field by field."""
    kwargs = dict(CASES[case], device="cpu")
    plain = decompose(_part(), **kwargs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = decompose(_part(), **kwargs)
    _assert_same(traced, plain)
    spans = _spans(prof)
    roots = [s for s in spans if s[0] == "repro_torch.decompose"]
    assert len(roots) == 1
    root = roots[0]
    assert all(_inside(s, root) for s in spans)
    for name in CALL_CHILDREN:
        assert [s[0] for s in spans].count(name) == 1, name
    sweeps = [s for s in spans if s[0] == "repro_torch.sweep"]
    assert len(sweeps) == traced.iterations >= 2
    for step in ("repro_torch.sweep.launch", "repro_torch.sweep.wait"):
        steps = [s for s in spans if s[0] == step]
        assert len(steps) == len(sweeps)
        for sweep in sweeps:
            assert sum(_inside(s, sweep) for s in steps) == 1
    assert {s[0] for s in spans} == {"repro_torch.decompose", "repro_torch.sweep",
                                     "repro_torch.sweep.launch", "repro_torch.sweep.wait",
                                     *CALL_CHILDREN}


def test_decompose_is_bit_identical_with_and_without_a_profiler():
    """The coreness and every counter of the result, with a profiler
    recording and without, for the fused engine from a resumed start."""
    start = np.asarray(_part().degrees, dtype=np.int32)
    kwargs = dict(op="fused", init_coreness=start, device="cpu")
    plain = decompose(_part(), **kwargs)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = decompose(_part(), **kwargs)
    _assert_same(traced, plain)


def test_bucketize_records_its_four_spans():
    g = rmat(9, 8, seed=3)
    plain = bucketize(g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = bucketize(g)
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["repro_torch.bucketize", *BUCKETIZE_CHILDREN]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert len(traced.buckets) == len(plain.buckets)
    np.testing.assert_array_equal(traced.bucket_adj, plain.bucket_adj)


def _divided():
    """A graph and one threshold that splits it into two non-empty parts."""
    g = rmat(10, 8, seed=7)
    return g, (int(peel_coreness(g).max()) // 2,)


def test_dc_kcore_records_its_spans_nested_under_its_root():
    """Under a CPU profiler a two-part Exact-Divide run records one
    ``repro_torch.dckcore`` root with every span of the run inside it: a
    plan a part and one for the end (``.divide``), a layout, a conquer
    (each holding one decomposition's root) and a merge a part, one shrink,
    and the divide passes inside the plan or the shrink that ran them. The
    coreness equals the unprofiled run's."""
    g, thresholds = _divided()
    kwargs = dict(strategy="exact", engine="fused", device="cpu")
    plain, _ = dc_kcore(g, thresholds, **kwargs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced, report = dc_kcore(g, thresholds, **kwargs)
    np.testing.assert_array_equal(traced, plain)
    assert len(report.parts) == 2
    spans = _spans(prof)
    roots = [s for s in spans if s[0] == "repro_torch.dckcore"]
    assert len(roots) == 1
    assert all(_inside(s, roots[0]) for s in spans)
    names = [s[0] for s in spans]
    assert {n: names.count(n) for n in DCKCORE_CHILDREN} == {
        "repro_torch.dckcore.divide": 2, "repro_torch.dckcore.layout": 2,
        "repro_torch.dckcore.conquer": 2, "repro_torch.dckcore.merge": 2,
        "repro_torch.dckcore.shrink": 1}
    by_name = {n: [s for s in spans if s[0] == n] for n in set(names)}
    for conquer in by_name["repro_torch.dckcore.conquer"]:
        assert sum(_inside(d, conquer) for d in by_name["repro_torch.decompose"]) == 1
    owners = by_name["repro_torch.dckcore.divide"] + by_name["repro_torch.dckcore.shrink"]
    for name in DIVIDE_SPANS:
        assert by_name[name]
        for s in by_name[name]:
            assert any(_inside(s, o) for o in owners), name
    assert [_inside(s, by_name["repro_torch.dckcore.shrink"][0])
            for s in by_name["repro_torch.divide.external"]] == [True]


def test_dc_kcore_records_nothing_without_a_profiler(monkeypatch):
    """No profiler records: the run never makes a profiler record."""
    g, thresholds = _divided()
    made = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: made.append(name))
    coreness, _ = dc_kcore(g, thresholds, strategy="exact", engine="fused", device="cpu")
    assert made == [] and (coreness >= 0).all()


@pytest.mark.cuda
def test_spans_stay_off_the_device_timeline(monkeypatch):
    """On the card the spans are host events alone: no device event of a
    CPU and CUDA profile carries a ``repro_torch.`` name, and the device
    events that the benchmark's ``profiling.split_events`` reads are the
    same operations, in the same order, with the spans recorded as with
    every span the no-op."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel has no CPU mode")
    from perfbench import profiling

    bg = bucketize(rmat(11, 8, seed=7))
    decompose(bg, op="fused", device="cuda")  # builds and loads the kernels

    def device_names():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            decompose(bg, op="fused", device="cuda")
            torch.cuda.synchronize()
        on_device = [e.name() for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA]
        assert not [n for n in on_device if n.startswith(trace.PREFIX)]
        return [e.name for e in sorted(profiling.split_events(prof)[0],
                                       key=lambda e: e.start_ns)]

    spanned = device_names()
    # ``repro_torch.core.decompose`` is also the name of the function the
    # package exports, so the module is taken from ``sys.modules``.
    monkeypatch.setattr(sys.modules["repro_torch.core.decompose"], "span",
                        lambda name: trace._OFF)
    assert device_names() == spanned
    assert any(n.startswith("void kcore::") for n in spanned)
