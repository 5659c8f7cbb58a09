"""Reading the program's spans: host events only, idle time owned exactly by
the innermost span, and the readers of spans and launch counters."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import harness, profiling, spans, spec
from perfbench.spans import OUTSIDE, Span

MS = 1_000_000  # ns


class _Event:
    def __init__(self, name, start, end, device=DeviceType.CPU, thread=1):
        self._name, self._start, self._end = name, start, end
        self._device, self._thread = device, thread

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def start_thread_id(self):
        return self._thread


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


CUDA = DeviceType.CUDA
DEVICE = [
    _Event("void kcore::row_per_warp<4, (anonymous namespace)::FusedPolicy<int> >()",
           12 * MS, 15 * MS, CUDA),
    _Event("Memcpy HtoD (Pageable -> Device)", 2 * MS, 6 * MS, CUDA),
    _Event("void at::native::indexFuncLargeIndex<int>()", 14 * MS, 18 * MS, CUDA),
    _Event("perfbench.window", 1 * MS, 30 * MS, CUDA),
]
HOST = [_Event("perfbench.window", 0, 31 * MS), _Event("aten::copy_", 2 * MS, 3 * MS)]
PROGRAM = [_Event("repro_torch.decompose", 1 * MS, 20 * MS),
           _Event("repro_torch.sweep", 10 * MS, 19 * MS),
           _Event("repro_torch.sweep.launch", 11 * MS, 13 * MS),
           _Event("repro_torch.sweep", 25 * MS, 26 * MS, thread=2)]


def test_program_spans_leave_the_device_reading_as_it_was():
    """The program's spans are host events: with them in the trace the
    device events, the window mark and every device sum read as without."""
    bare = profiling.split_events(_prof(DEVICE + HOST))
    spanned = profiling.split_events(_prof(DEVICE + HOST + PROGRAM))
    assert spanned == bare
    events, marks = spanned
    lo, hi = marks[profiling.WINDOW_MARK]
    a = profiling.summarize(bare[0], lo, hi)
    b = profiling.summarize(events, lo, hi)
    assert (a.kernel_s, a.busy_s, a.upload_s, a.device_ops) == \
        (b.kernel_s, b.busy_s, b.upload_s, b.device_ops)
    assert b.busy_s == pytest.approx(10e-3)


def test_host_spans_take_the_host_events_of_a_prefix():
    got = spans.host_spans(_prof(DEVICE + HOST + PROGRAM))
    assert got == [Span(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.start_thread_id()) for e in PROGRAM]
    marks = spans.host_spans(_prof(DEVICE + HOST), (profiling.WINDOW_MARK,))
    assert marks == [Span(profiling.WINDOW_MARK, 0, 31 * MS, 1)]


# One thread's spans over a window [0, 100): a root with two children, the
# second of which has a child of its own.
NESTED = [Span("root", 10, 90, 1), Span("a", 20, 40, 1), Span("b", 50, 80, 1),
          Span("b.c", 60, 70, 1)]


def test_innermost_cuts_the_window_into_self_times():
    pieces = spans.innermost(NESTED, 0, 100)
    assert pieces == [(0, 10, OUTSIDE), (10, 20, "root"), (20, 40, "a"), (40, 50, "root"),
                      (50, 60, "b"), (60, 70, "b.c"), (70, 80, "b"), (80, 90, "root"),
                      (90, 100, OUTSIDE)]


def test_idle_by_span_gives_each_owner_its_exact_share():
    """Gaps that straddle span edges are split at them, a gap outside every
    span goes to OUTSIDE, and the shares add up to the idle time."""
    idle = [(5, 15), (35, 55), (65, 75), (95, 100)]
    got = spans.idle_by_span(NESTED, idle, 0, 100)
    want_ns = {OUTSIDE: 5 + 5, "root": 5 + 10, "a": 5, "b": 5 + 5, "b.c": 5}
    assert got == pytest.approx({k: v / 1e9 for k, v in want_ns.items()})
    assert sum(got.values()) == pytest.approx(sum(b - a for a, b in idle) / 1e9)


def test_idle_by_span_clips_spans_to_the_window():
    got = spans.idle_by_span([Span("s", -50, 20, 1)], [(0, 30)], 0, 30)
    assert got == pytest.approx({"s": 20e-9, OUTSIDE: 10e-9})


def test_per_call_sums_each_decomposition():
    calls_spans = [Span(spans.ROOT_SPAN, 0, 100 * MS, 1),
                   Span(spans.SWEEP, 10 * MS, 50 * MS, 1),
                   Span(spans.WAIT, 40 * MS, 50 * MS, 1),
                   Span(spans.SWEEP, 60 * MS, 90 * MS, 1),
                   Span(spans.ROOT_SPAN, 200 * MS, 210 * MS, 1)]
    calls = spans.per_call(calls_spans, [(45 * MS, 65 * MS), (150 * MS, 205 * MS)])
    assert [c["sweeps"] for c in calls] == [2, 0]
    first = calls[0]
    assert first["host_ms"] == pytest.approx({spans.ROOT_SPAN: 100, spans.SWEEP: 70,
                                              spans.WAIT: 10})
    assert first["self_ms"] == pytest.approx({spans.ROOT_SPAN: 30, spans.SWEEP: 60,
                                              spans.WAIT: 10})
    assert first["idle_ms"] == pytest.approx({spans.WAIT: 5, spans.ROOT_SPAN: 10,
                                              spans.SWEEP: 5})
    assert calls[1]["idle_ms"] == pytest.approx({spans.ROOT_SPAN: 5})


def _context(**extra):
    base = dict(results=[SimpleNamespace(iterations=2), SimpleNamespace(iterations=1)],
                latencies_s=[1.0, 1.0], window_s=2.0, setup_s=0.0, peak_bytes=0, facts={})
    return spans.SpanContext(**base, **extra) if extra else harness.Context(**base)


# Two decompositions of one thread: prep 1 + 2 + 3 ms and tiles 10 ms in the
# first, prep 6 ms and tiles 20 ms in the second; three sweeps of 8, 4 and
# 6 ms with waits of 2, 1 and 3 ms.
SYNTHETIC = [
    Span(spans.ROOT_SPAN, 0, 100 * MS, 1),
    Span("repro_torch.decompose.guard", 0, 1 * MS, 1),
    Span("repro_torch.decompose.start", 1 * MS, 3 * MS, 1),
    Span("repro_torch.decompose.cand", 3 * MS, 6 * MS, 1),
    Span(spans.TILES, 6 * MS, 16 * MS, 1),
    Span(spans.SWEEP, 20 * MS, 28 * MS, 1),
    Span(spans.WAIT, 26 * MS, 28 * MS, 1),
    Span(spans.SWEEP, 30 * MS, 34 * MS, 1),
    Span(spans.WAIT, 33 * MS, 34 * MS, 1),
    Span(spans.ROOT_SPAN, 200 * MS, 300 * MS, 1),
    Span("repro_torch.decompose.cand", 200 * MS, 206 * MS, 1),
    Span(spans.TILES, 206 * MS, 226 * MS, 1),
    Span(spans.SWEEP, 230 * MS, 236 * MS, 1),
    Span(spans.WAIT, 233 * MS, 236 * MS, 1),
]
IDLE = {spans.SWEEP: 0.006, "repro_torch.sweep.launch": 0.002, spans.WAIT: 0.001,
        spans.ROOT_SPAN: 0.5, OUTSIDE: 0.25}
COUNTERS = {"launches": 7}
WANT = {"prep.host_ms": 6.0, "tiles.host_ms": 15.0, "sweep.host_ms": 4.0,
        "sweep.wait_ms": 2.0, "sweep.idle_ms": 3.0, "kernels.launches": 3.5}


@pytest.mark.parametrize("name", spans.SPAN_READERS)
def test_span_reader_reads_nothing_without_spans_or_counters(name):
    reader = spec.load_metric(name)
    assert reader.read(_context()) is None
    assert reader.read(_context(spans=None, span_idle=None, counters=None)) is None
    assert reader.read(_context(spans=[], span_idle={}, counters={"launches": 0})) is None


@pytest.mark.parametrize("name", spans.SPAN_READERS)
def test_span_reader_reads_a_synthetic_window(name):
    ctx = _context(spans=SYNTHETIC, span_idle=IDLE, counters=COUNTERS)
    assert spec.load_metric(name).read(ctx) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name, key", [
    ("void kcore::row_per_group<8, (anonymous namespace)::FusedPolicy<short> >(...)",
     "group:8"),
    ("void kcore::row_per_group<16, (anonymous namespace)::FusedPolicy<int> >(...)",
     "group:16"),
    ("void kcore::row_per_warp<1, (anonymous namespace)::FusedPolicy<short> >(...)",
     "warp:1"),
    ("void kcore::row_per_warp<32, (anonymous namespace)::FusedPolicy<int> >(...)",
     "warp:32"),
    ("void kcore::row_per_cluster<(anonymous namespace)::FusedPolicy<int> >(...)", "hist"),
    ("void kcore::row_per_block<(anonymous namespace)::FusedPolicy<int> >(...)", "search"),
    ("void kcore::row_per_warp<4, (anonymous namespace)::HindexPolicy>(...)", None),
    ("void at::native::indexFuncLargeIndex<int, long, unsigned int, 1, 1, -2>(...)", None),
    ("Memcpy HtoD (Pageable -> Device)", None),
])
def test_fused_kernel_key_reads_the_kernel_name(name, key):
    assert spans.fused_kernel_key(name) == key


def test_checks_hold_the_counters_to_the_trace():
    ctx = _context(spans=SYNTHETIC, span_idle=IDLE, counters=COUNTERS)
    extra = {"calls": spans.per_call(SYNTHETIC, []),
             "fused_events": {"hist": 3, "warp:32": 4}}
    assert all(spans.checks(ctx, extra).values())
    extra["fused_events"] = {"hist": 3, "warp:32": 5}
    assert not spans.checks(ctx, extra)["launches_equal_trace"]
    ctx.results[0].iterations = 3
    assert not spans.checks(ctx, extra)["sweep_spans_equal_iterations"]


def test_per_call_splits_a_set_up_into_its_bucketize_phases():
    """Read by ``--setup``: per bucketize root, each phase's host ms and the
    root's self time outside them."""
    setup = [Span(spans.BUCKETIZE, 0, 100 * MS, 1),
             Span(spans.BUCKETIZE + ".caps", 0, 10 * MS, 1),
             Span(spans.BUCKETIZE + ".tiles", 10 * MS, 70 * MS, 1),
             Span(spans.BUCKETIZE + ".adjacency", 75 * MS, 95 * MS, 1)]
    (call,) = spans.per_call(setup, [], spans.BUCKETIZE)
    assert call["host_ms"] == pytest.approx({spans.BUCKETIZE: 100,
                                             spans.BUCKETIZE + ".caps": 10,
                                             spans.BUCKETIZE + ".tiles": 60,
                                             spans.BUCKETIZE + ".adjacency": 20})
    assert call["self_ms"][spans.BUCKETIZE] == pytest.approx(10)
    assert call["idle_ms"] == {}
    assert spans.per_call(setup, []) == []
