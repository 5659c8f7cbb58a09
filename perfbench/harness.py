"""One run of one cell: set-up, the timed window, the trace, the check.

The traffic file names a runner (``runners/<name>.py``), which makes the
cell's inputs from the seed, sets the program up on them, and says what one
call of the window is and what the reference answers. This module only
runs that: set-up (the runner's part and one warm call, then the
peak-memory counter reset), then the window, which calls the part back to
back (a closed loop, one call at a time) or, where the traffic gives
``arrivals_per_s``, at arrivals that far apart (an open loop with one
server: a call waits for the one before it), each call ending in a
synchronize, until ``seconds`` have passed. With ``trace`` the window runs
under ``torch.profiler`` and a host sampler, and the runner's
``sweep_once`` (if it has one) is profiled alone afterwards.

Once the window has closed and the peak has been read, the part is freed
and the runner's reference answers from the seed; every answer of the
window must equal it element for element. Every metric, end to end or per
layer, is read from a :class:`Context` by ``metrics/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import profiling, spec


@dataclasses.dataclass
class Context:
    """What the metric readers (``metrics/<name>.py``) read."""

    results: list  # the window's answers, as the program returned them
    latencies_s: List[float]  # each call's seconds from its arrival to its end
    window_s: float
    setup_s: float
    peak_bytes: int
    facts: dict  # the runner's numbers of its set-up (``layout_s``, ...)
    trace: Optional[profiling.WindowTrace] = None
    sweep_kernel_s: Optional[float] = None  # kernels of the runner's sweep_once


@dataclasses.dataclass
class Check:
    """A number compared with its limit: correct iff ``value <= limit``."""

    name: str
    value: int
    limit: int

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare(answers: list, want: np.ndarray, failures: int):
    """The numbers that decide ``correct`` and the count of wrong answers.

    The numbers: the most elements in which one answer differs from the
    reference's, and the calls that raised or answered with the wrong
    shape. Both are held to 0."""
    mismatched, unanswered, wrong = 0, failures, 0
    for got in answers:
        got = np.asarray(got)
        if got.shape != want.shape:
            unanswered += 1
            continue
        differ = int(np.count_nonzero(got != want))
        mismatched = max(mismatched, differ)
        wrong += differ > 0
    checks = [Check("mismatched_nodes", mismatched, 0),
              Check("unanswered", unanswered, 0)]
    return checks, wrong + unanswered


def window(call: Callable, seconds: float, sync: Callable,
           arrivals_per_s: Optional[float] = None, log=sys.stderr):
    """Call ``call`` until ``seconds`` have passed; returns its results, each
    call's latency, the count that raised and the window's length."""
    results, latencies, failures = [], [], 0
    start = time.perf_counter()
    while True:
        arrival = time.perf_counter()
        if arrivals_per_s:
            arrival = start + len(latencies) / arrivals_per_s
            time.sleep(max(0.0, arrival - time.perf_counter()))
        try:
            results.append(call())
        except Exception:  # a call that raises is reported, not retried
            failures += 1
            if failures == 1:
                traceback.print_exc(file=log)
        sync()
        now = time.perf_counter()
        latencies.append(now - arrival)
        if now - start >= seconds:
            return results, latencies, failures, now - start


def run(config: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
        metrics: List[dict], readers: Dict, device="cuda", chips: int = 1,
        setup_start: Optional[float] = None, entry: Optional[Callable] = None,
        log=sys.stderr) -> dict:
    """Run the cell once and return its result (``run.py`` prints it).

    ``metrics`` are the cell's entries of ``BENCHMARK.json`` to report (its
    ``end_to_end`` ones without ``trace``, its ``per_layer`` ones with it),
    read by ``readers`` (``{name: module with read(ctx)}``). ``entry``
    stands in for the program's function that the runner calls (tests and
    the control break it on purpose).
    """
    t0 = time.perf_counter() if setup_start is None else setup_start
    dev = torch.device(device)
    runner = spec.load_runner(traffic["runner"])
    part = runner.Part(config, traffic, seed, dev, entry=entry)
    warm = part.call()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    print(f"perfbench: set-up {setup_s:.3f} s ({part.describe(warm)})", file=log)
    del warm

    def timed():
        return window(part.call, seconds, lambda: _sync(dev),
                      traffic.get("arrivals_per_s"), log)

    window_trace = sweep_kernel_s = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with profiling.HostSampler() as sampler:
                host_mark = time.time_ns()
                with record_function(profiling.WINDOW_MARK):
                    results, latencies, failures, window_s = timed()
        t_read = time.perf_counter()
        events, marks = profiling.split_events(prof)
        lo, hi = marks[profiling.WINDOW_MARK]
        window_trace = profiling.summarize(
            events, lo, hi, [t + lo - host_mark for t in sampler.times_ns],
            sampler.names)
        print(f"perfbench: trace of {len(events)} device events and "
              f"{len(sampler.times_ns)} host samples read in "
              f"{time.perf_counter() - t_read:.3f} s", file=log)
        del prof, events
    else:
        results, latencies, failures, window_s = timed()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attempted = len(results) + failures
    print(f"perfbench: window {window_s:.3f} s, {attempted} calls, {failures} "
          f"raised; latency of each (s): "
          + " ".join(f"{x:.4f}" for x in latencies), file=log)

    if trace and hasattr(part, "sweep_once"):
        with profile(activities=activities) as prof:
            part.sweep_once()
            _sync(dev)
        sweep_kernel_s = profiling.kernel_seconds(profiling.split_events(prof)[0])
        del prof

    answers = [part.answer(r) for r in results]
    facts = part.facts
    part.close()
    del part
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = runner.reference_answer(config, traffic, seed, dev)
    checks, failed = compare(answers, want, failures)
    print(f"perfbench: reference {time.perf_counter() - t_ref:.3f} s, largest "
          f"answer {int(want.max(initial=0))}", file=log)
    correct = bool(results) and all(c.ok for c in checks)

    ctx = Context(results=results, latencies_s=latencies, window_s=window_s,
                  setup_s=setup_s, peak_bytes=int(peak), facts=facts,
                  trace=window_trace, sweep_kernel_s=sweep_kernel_s)
    values = {m["name"]: readers[m["name"]].read(ctx) for m in metrics}
    reported = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                for m in metrics if values[m["name"]] is not None}

    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": reported,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type),
            "count": chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if window_trace is not None:
        result["device"]["busy_s"] = window_trace.busy_s
        result["device"]["window_s"] = window_trace.window_s
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in window_trace.device_ops],
            "idle_gaps": [[k, v] for k, v in window_trace.idle_gaps],
        }
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result
