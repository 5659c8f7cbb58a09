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
from repro_torch.core.decompose import decompose
from repro_torch.graph import bucketize
from repro_torch.graph.generators import rmat

torch.set_num_threads(1)

CALL_CHILDREN = ("repro_torch.decompose.guard", "repro_torch.decompose.start",
                 "repro_torch.decompose.cand", "repro_torch.decompose.tiles",
                 "repro_torch.decompose.result")
BUCKETIZE_CHILDREN = ("repro_torch.bucketize.caps", "repro_torch.bucketize.tiles",
                      "repro_torch.bucketize.adjacency")
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
