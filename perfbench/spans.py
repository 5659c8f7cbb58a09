"""The program's spans in a traced window, and what they own of the idle card.

    python3 perfbench/spans.py --workload kron-s24-conquer --seed 11 --seconds 50 [--setup]

sets the cell up as ``run.py`` does, runs one window of ``seconds`` under
``torch.profiler`` (no host sampler), and reads the spans that the port
records there (``src/repro_torch/trace.py``: host events named
``repro_torch.*``, on the clock of the device trace). Every idle interval of
the device in the window is put down to the innermost span open on the
calling thread at that instant, by exact interval intersection; idle time
outside every span goes under :data:`OUTSIDE`. Standard error gets, per
decomposition, host ms by span (total and self) and device-idle ms by span,
and the fused kernel's launches by path, read from the kernel names of the
device trace. The last line of standard output is one JSON object with the
readings of the per-layer readers that read spans and counters
(``prep.host_ms``, ``tiles.host_ms``, ``sweep.host_ms``, ``sweep.wait_ms``,
``sweep.idle_ms``, ``kernels.launches``) and of the trace (``kernels.ms``,
``upload.ms``, ``device.idle_share``), the idle by span, and ``checks``:
each sweep span count against the call's ``iterations``, the launch counter
against the fused-kernel events of the trace, and the window's answers
against the reference. It exits 1 where a check fails.

``--setup`` also profiles the set-up (CPU activity only) and reports the
host ms of ``repro_torch.bucketize`` and of its phases ``.caps``, ``.tiles``
and ``.adjacency``; the profiler lengthens that set-up, and no metric
reads it.

Runs on the GPU only; the benchmark's own runs never run it. The window here
repeats ``harness.run``'s traced window because ``harness.run`` keeps no
spans: :func:`traced_window` and :func:`main`'s window go once the harness
hands its readers the spans itself.
"""
from __future__ import annotations

import collections
import dataclasses
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

from perfbench import harness, profiling  # noqa: E402

PREFIX = "repro_torch."
ROOT_SPAN = "repro_torch.decompose"
SWEEP = "repro_torch.sweep"
WAIT = "repro_torch.sweep.wait"
PREP = ("repro_torch.decompose.guard", "repro_torch.decompose.start",
        "repro_torch.decompose.cand")
TILES = "repro_torch.decompose.tiles"
BUCKETIZE = "repro_torch.bucketize"
OUTSIDE = "outside program spans"
SPAN_READERS = ("prep.host_ms", "tiles.host_ms", "sweep.host_ms", "sweep.wait_ms",
                "sweep.idle_ms", "kernels.launches")
TRACE_READERS = ("kernels.ms", "upload.ms", "device.idle_share")


@dataclasses.dataclass
class Span:
    """One host span of a trace: ``[start_ns, end_ns)`` on the profiler's
    clock, on the profiler's id of the thread that opened it."""

    name: str
    start_ns: int
    end_ns: int
    thread: int


@dataclasses.dataclass
class SpanContext(harness.Context):
    """A :class:`harness.Context` with what the span and counter readers
    read: the program's spans of the window on the calling thread, the
    window's device-idle seconds by innermost span (:func:`idle_by_span`),
    and ``{"launches": n}``, the fused kernel's launch counter's difference
    over the window (:func:`launches`)."""

    spans: Optional[List[Span]] = None
    span_idle: Optional[Dict[str, float]] = None
    counters: Optional[dict] = None


def host_spans(prof, prefixes: Iterable[str] = (PREFIX,)) -> List[Span]:
    """The host events of a finished profile whose names start with one of
    ``prefixes`` (a ``record_function`` mark shows on the device too: only
    its host event is taken)."""
    from torch.autograd import DeviceType

    prefixes = tuple(prefixes)
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA or not e.name().startswith(prefixes):
            continue
        start, end = profiling._span_ns(e)
        out.append(Span(e.name(), start, end, int(e.start_thread_id())))
    return out


def innermost(spans: Sequence[Span], lo: int, hi: int) -> List[Tuple[int, int, str]]:
    """``[lo, hi)`` cut into ``(start, end, name)`` pieces, each named by
    the innermost of ``spans`` (of one thread, so nested) open over it, or
    :data:`OUTSIDE`. A span's pieces add up to its self time."""
    pieces: List[Tuple[int, int, str]] = []
    stack: List[Span] = []
    cursor = lo

    def emit(upto: int):
        nonlocal cursor
        upto = min(upto, hi)
        if upto > cursor:
            pieces.append((cursor, upto, stack[-1].name if stack else OUTSIDE))
            cursor = upto

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        if s.end_ns <= lo or s.start_ns >= hi:
            continue
        while stack and stack[-1].end_ns <= s.start_ns:
            emit(stack[-1].end_ns)  # the piece up to its end is the span's own
            stack.pop()
        emit(s.start_ns)
        stack.append(s)
    while stack:
        emit(stack[-1].end_ns)
        stack.pop()
    emit(hi)
    return pieces


def overlap_by_name(pieces: Sequence[Tuple[int, int, str]],
                    intervals: Sequence[Tuple[int, int]]) -> Dict[str, float]:
    """Seconds of the sorted, disjoint ``intervals`` that fall in the
    pieces of each name (pieces as :func:`innermost` makes them)."""
    totals: Dict[str, float] = collections.defaultdict(float)
    j = 0
    for a, b in intervals:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            totals[name] += (min(b, e) - max(a, s)) / 1e9
            k += 1
    return dict(totals)


def idle_by_span(spans: Sequence[Span], idle: Sequence[Tuple[int, int]], lo: int,
                 hi: int) -> Dict[str, float]:
    """Device-idle seconds of ``[lo, hi)`` by the innermost of ``spans``
    (one thread's) open over them; ``idle`` are the window's idle
    intervals, sorted (``profiling.gaps``). The values add up to the idle
    time."""
    return overlap_by_name(innermost(spans, lo, hi), idle)


def per_call(spans: Sequence[Span], idle: Sequence[Tuple[int, int]],
             root_name: str = ROOT_SPAN) -> List[dict]:
    """Per ``root_name`` span (one decomposition by default), in order: its
    sweeps and, by span name, host ms in all (``host_ms``) and outside the
    span's children (``self_ms``), and the device-idle ms it owns
    (``idle_ms``)."""
    calls = []
    ordered = sorted(spans, key=lambda s: s.start_ns)
    for root in (s for s in ordered if s.name == root_name):
        lo, hi = root.start_ns, root.end_ns
        inside = [s for s in ordered if s.start_ns >= lo and s.end_ns <= hi]
        pieces = innermost(inside, lo, hi)
        host, own = collections.defaultdict(float), collections.defaultdict(float)
        for s in inside:
            host[s.name] += (s.end_ns - s.start_ns) / 1e6
        for s, e, name in pieces:
            own[name] += (e - s) / 1e6
        idle_ms = {k: 1e3 * v for k, v in
                   overlap_by_name(pieces, profiling.clip(idle, lo, hi)).items()}
        calls.append({"sweeps": sum(s.name == SWEEP for s in inside),
                      "host_ms": dict(host), "self_ms": dict(own), "idle_ms": idle_ms})
    return calls


def _spans(ctx) -> Optional[List[Span]]:
    spans = getattr(ctx, "spans", None)
    return spans if spans else None


def ms_per_call(ctx, names: Sequence[str]) -> Optional[float]:
    """Host ms in the spans ``names`` per decomposition (:data:`ROOT_SPAN`)
    of ``ctx.spans``; ``None`` without spans."""
    spans = _spans(ctx)
    calls = sum(s.name == ROOT_SPAN for s in spans) if spans else 0
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names) / 1e6 / calls


def ms_per_sweep(ctx, names: Sequence[str], less: Sequence[str] = ()) -> Optional[float]:
    """Host ms in the spans ``names``, less those in ``less``, per
    :data:`SWEEP` span of ``ctx.spans``; ``None`` without sweeps."""
    spans = _spans(ctx)
    sweeps = sum(s.name == SWEEP for s in spans) if spans else 0
    if not sweeps:
        return None
    ns = (sum(s.end_ns - s.start_ns for s in spans if s.name in names)
          - sum(s.end_ns - s.start_ns for s in spans if s.name in less))
    return ns / 1e6 / sweeps


def idle_ms_per_sweep(ctx) -> Optional[float]:
    """Device-idle ms that fall inside :data:`SWEEP` spans (their children
    included) per sweep; ``None`` without spans or their idle."""
    spans, idle = _spans(ctx), getattr(ctx, "span_idle", None)
    sweeps = sum(s.name == SWEEP for s in spans) if spans else 0
    if not sweeps or idle is None:
        return None
    inside = sum(v for k, v in idle.items() if k == SWEEP or k.startswith(SWEEP + "."))
    return 1e3 * inside / sweeps


def launches() -> int:
    """The fused kernel's launch counter as it stands
    (``fused_sweep_op.launches``, ``kernels/plan.py`` ``count_launch``)."""
    from repro_torch.kernels.fused import fused_sweep_op

    return fused_sweep_op.launches


_FUSED_KERNEL = re.compile(r"kcore::(row_per_group|row_per_warp|row_per_cluster|row_per_block)"
                           r"(?:<(\d+),)?")
_KEY_OF_KERNEL = {"row_per_group": "group", "row_per_warp": "warp",
                  "row_per_cluster": "hist", "row_per_block": "search"}


def fused_kernel_key(name: str) -> Optional[str]:
    """The path of a device event of the fused kernel, read from the
    kernel's name in the trace (``csrc/hist_common.cuh`` ``launch_row_plan``):
    ``group:<G>`` for ``row_per_group<G>`` (G lanes a row), ``warp:<V>`` for
    ``row_per_warp<V>`` (V values a lane), ``hist`` for ``row_per_cluster``,
    ``search`` for ``row_per_block``; ``None`` for any other event."""
    m = _FUSED_KERNEL.search(name)
    if m is None or "FusedPolicy" not in name:
        return None
    path = _KEY_OF_KERNEL[m.group(1)]
    return f"{path}:{m.group(2)}" if m.group(2) else path


def traced_window(call, seconds: float, device) -> Tuple[SpanContext, dict]:
    """Run ``call`` back to back for ``seconds`` under the profiler (as
    ``harness.run`` does with ``trace``, without the host sampler) and read
    the window: the context the readers read, and what the checks and the
    per-decomposition lines need (``calls``, and ``fused_events``: the
    fused kernel's device events of the window by path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before = launches()
    with profile(activities=activities) as prof:
        with record_function(profiling.WINDOW_MARK):
            results, latencies, failures, window_s = harness.window(
                call, seconds, lambda: harness._sync(dev))
    launched = launches() - before
    events, marks = profiling.split_events(prof)
    lo, hi = marks[profiling.WINDOW_MARK]
    hosts = host_spans(prof, (PREFIX, profiling.WINDOW_MARK))
    del prof
    thread = next(s.thread for s in hosts if s.name == profiling.WINDOW_MARK)
    spans = [s for s in hosts if s.name.startswith(PREFIX) and s.thread == thread
             and s.end_ns > lo and s.start_ns < hi]
    inside = [e for e in events if e.end_ns > lo and e.start_ns < hi]
    busy = profiling.clip(profiling.union([(e.start_ns, e.end_ns) for e in inside]), lo, hi)
    idle = profiling.gaps(busy, lo, hi)
    fused = collections.Counter(k for k in map(fused_kernel_key, (e.name for e in inside))
                                if k)
    ctx = SpanContext(results=results, latencies_s=latencies, window_s=window_s,
                      setup_s=0.0, peak_bytes=0, facts={},
                      trace=profiling.summarize(events, lo, hi),
                      spans=spans, span_idle=idle_by_span(spans, idle, lo, hi),
                      counters={"launches": launched})
    return ctx, {"calls": per_call(spans, idle), "fused_events": dict(fused),
                 "failures": failures}


def checks(ctx: SpanContext, extra: dict) -> Dict[str, bool]:
    """The window's own consistency: one sweep span a sweep of each call,
    and the launch counter equal to the fused-kernel events of the trace."""
    return {
        "sweep_spans_equal_iterations": (
            len(extra["calls"]) == len(ctx.results)
            and all(c["sweeps"] == r.iterations
                    for c, r in zip(extra["calls"], ctx.results))),
        "launches_equal_trace": (ctx.counters["launches"]
                                 == sum(extra["fused_events"].values())),
    }


def _print_calls(calls: List[dict], fused_events: dict, n_calls: int, log) -> None:
    for i, call in enumerate(calls):
        names = sorted(call["host_ms"], key=lambda k: -call["host_ms"][k])
        print(f"perfbench: decomposition {i}: {call['sweeps']} sweeps; span: host ms "
              f"(self), device-idle ms", file=log)
        for name in names + ([OUTSIDE] if OUTSIDE in call["idle_ms"] else []):
            print(f"perfbench:   {name}: {call['host_ms'].get(name, 0.0):.3f} "
                  f"({call['self_ms'].get(name, 0.0):.3f}), "
                  f"{call['idle_ms'].get(name, 0.0):.3f}", file=log)
    for key in sorted(fused_events):
        print(f"perfbench: fused launches by path {key}: "
              f"{fused_events[key] / max(n_calls, 1):.2f} a call", file=log)


def _setup(runner, config: dict, traffic: dict, seed: int, dev, profiled: bool):
    """The runner's part, and with ``profiled`` the host ms (total and self)
    of each ``repro_torch.bucketize`` span of its set-up, under a CPU-only
    profiler; ``None`` without."""
    if not profiled:
        return runner.Part(config, traffic, seed, dev), None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        part = runner.Part(config, traffic, seed, dev)
    calls = per_call(host_spans(prof, (BUCKETIZE,)), [], BUCKETIZE)
    del prof
    return part, calls


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from perfbench import spec

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--setup", action="store_true",
                   help="also profile the set-up and report bucketize's phases")
    args = p.parse_args(argv)
    try:
        bench = spec.load_benchmark()
        cell = spec.find_cell(bench, args.workload)
        config = spec.load_config(cell["config"])
        traffic = spec.load_traffic(cell["traffic"])
        readers = {name: spec.load_metric(name) for name in SPAN_READERS + TRACE_READERS}
    except spec.SpecError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    runner = spec.load_runner(traffic["runner"])
    part, setup = _setup(runner, config, traffic, args.seed, dev, args.setup)
    part.call()
    harness._sync(dev)
    ctx, extra = traced_window(part.call, args.seconds, dev)
    answers = [part.answer(r) for r in ctx.results]
    part.close()
    del part
    torch.cuda.empty_cache()
    want = runner.reference_answer(config, traffic, args.seed, dev)
    compared, _ = harness.compare(answers, want, extra["failures"])
    if setup is not None:
        print("perfbench: set-up; span: host ms (self)", file=sys.stderr)
        for call in setup:
            for name, ms in call["host_ms"].items():
                print(f"perfbench:   {name}: {ms:.3f} ({call['self_ms'].get(name, 0.0):.3f})",
                      file=sys.stderr)
    _print_calls(extra["calls"], extra["fused_events"], len(ctx.results), sys.stderr)
    result = checks(ctx, extra)
    result["answers_equal_reference"] = bool(ctx.results) and all(c.ok for c in compared)
    line = {
        "workload": cell["name"], "seed": args.seed,
        "device": torch.cuda.get_device_name(dev), "calls": len(ctx.results),
        "window_s": ctx.window_s,
        "metrics": {name: readers[name].read(ctx) for name in readers},
        "span_idle_s": ctx.span_idle,
        "idle_s": ctx.trace.window_s - ctx.trace.busy_s,
        "fused_launches_by_path": extra["fused_events"],
        "checks": result,
    }
    if setup is not None:
        line["setup_host_ms"] = [call["host_ms"] for call in setup]
    print(json.dumps(line), flush=True)
    return 0 if all(result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
