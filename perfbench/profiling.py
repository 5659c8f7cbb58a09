"""Read a ``torch.profiler`` trace of the window: device time by kind, the
union of busy intervals, and the idle gaps named by what the host did.

The device's busy time is the union of the intervals in which a kernel, a
copy or a set ran, not their sum, so that work on overlapping streams is
not counted twice. A :class:`HostSampler` thread records the main
thread's innermost frame of the program (or of the harness) every
millisecond; each idle gap of the device is named by the frame sampled
most often inside it. Gaps too short to hold a sample are pooled under
``_gaps_shorter_than_a_sample_``.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

SHORT_GAPS = "_gaps_shorter_than_a_sample_"
MARK_PREFIX = "perfbench."
WINDOW_MARK = MARK_PREFIX + "window"
TOP = 10
NAME_CHARS = 120


def short_name(name: str) -> str:
    """A device operation's name cut to ``NAME_CHARS`` characters (kernel
    names carry their whole template signature)."""
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


def frame_name(frame) -> str:
    """``module:function`` of the innermost frame of the port, else of the
    harness, else of whatever runs."""
    innermost = None
    harness = None
    while frame is not None:
        module = frame.f_globals.get("__name__", "?")
        name = f"{module}:{frame.f_code.co_name}"
        if innermost is None:
            innermost = name
        if module.split(".", 1)[0] == "repro_torch":
            return name
        if harness is None and module.startswith("perfbench"):
            harness = name
        frame = frame.f_back
    return harness or innermost or "?"


class HostSampler:
    """Samples one thread's current frame every ``interval_s`` seconds on a
    thread of its own; ``times_ns`` are ``time.time_ns()`` readings."""

    def __init__(self, interval_s: float = 0.001):
        self.interval_s = interval_s
        self.target = threading.get_ident()
        self.times_ns: List[int] = []
        self.names: List[str] = []
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._run, name="perfbench-sampler",
                                        daemon=True)

    def _run(self):
        while not self._halt.wait(self.interval_s):
            frame = sys._current_frames().get(self.target)
            self.times_ns.append(time.time_ns())
            self.names.append(frame_name(frame))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._halt.set()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            raise RuntimeError("host sampler thread did not stop")
        return False


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int


def _span_ns(event) -> Tuple[int, int]:
    if hasattr(event, "start_ns"):
        start = int(event.start_ns())
        return start, start + int(event.duration_ns())
    start = int(event.start_us()) * 1000
    return start, start + int(event.duration_us()) * 1000


def split_events(prof) -> Tuple[List[DeviceEvent], Dict[str, Tuple[int, int]]]:
    """The device events of a finished ``torch.profiler.profile`` and the
    spans of its host annotations (``record_function`` names)."""
    from torch.autograd import DeviceType

    device, marks = [], {}
    for e in prof.profiler.kineto_results.events():
        start, end = _span_ns(e)
        if e.name().startswith(MARK_PREFIX):
            # An annotation shows on the host and, spanning the kernels it
            # enclosed, on the device: only the host's span is a mark.
            if e.device_type() != DeviceType.CUDA:
                marks[e.name()] = (start, end)
        elif e.device_type() == DeviceType.CUDA:
            device.append(DeviceEvent(short_name(e.name()), start, end))
    return device, marks


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def is_upload(name: str) -> bool:
    return name.startswith("Memcpy HtoD")


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted ``[start, end)`` intervals."""
    merged: List[List[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def clip(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(busy: Sequence[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle intervals of ``[lo, hi)`` between merged busy intervals."""
    out, cursor = [], lo
    for start, end in busy:
        if start > cursor:
            out.append((cursor, start))
        cursor = max(cursor, end)
    if hi > cursor:
        out.append((cursor, hi))
    return out


def name_gaps(idle: Sequence[Tuple[int, int]], sample_ns: Sequence[int],
              sample_names: Sequence[str]) -> List[Tuple[str, float]]:
    """Seconds of idle time by the host frame sampled most inside each gap,
    largest first, at most ``TOP`` entries."""
    totals: Dict[str, float] = collections.defaultdict(float)
    if not idle:
        return []
    times = np.asarray(sample_ns, dtype=np.int64)
    order = np.argsort(times, kind="stable")
    times = times[order]
    names = [sample_names[i] for i in order]
    bounds = np.asarray(idle, dtype=np.int64)
    first = np.searchsorted(times, bounds[:, 0])
    past = np.searchsorted(times, bounds[:, 1])
    seconds = (bounds[:, 1] - bounds[:, 0]) / 1e9
    empty = past == first
    totals[SHORT_GAPS] = float(seconds[empty].sum())
    for i in np.nonzero(~empty)[0]:
        name = collections.Counter(names[first[i]:past[i]]).most_common(1)[0][0]
        totals[name] += float(seconds[i])
    if totals[SHORT_GAPS] == 0.0:
        del totals[SHORT_GAPS]
    return sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]


@dataclasses.dataclass
class WindowTrace:
    """What the device did in a traced window, in seconds."""

    window_s: float
    busy_s: float
    kernel_s: float
    upload_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def summarize(events: Sequence[DeviceEvent], lo_ns: int, hi_ns: int,
              sample_ns: Sequence[int] = (), sample_names: Sequence[str] = ()
              ) -> WindowTrace:
    """Reduce the device events of ``[lo_ns, hi_ns)`` (the trace's clock;
    samples already moved onto it) to a :class:`WindowTrace`."""
    inside = [e for e in events if e.end_ns > lo_ns and e.start_ns < hi_ns]
    by_name: Dict[str, float] = collections.defaultdict(float)
    kernel_s = upload_s = 0.0
    for e in inside:
        seconds = (e.end_ns - e.start_ns) / 1e9
        by_name[e.name] += seconds
        if is_upload(e.name):
            upload_s += seconds
        elif not is_copy(e.name):
            kernel_s += seconds
    busy = clip(union([(e.start_ns, e.end_ns) for e in inside]), lo_ns, hi_ns)
    busy_s = sum(e - s for s, e in busy) / 1e9
    idle = gaps(busy, lo_ns, hi_ns)
    return WindowTrace(
        window_s=(hi_ns - lo_ns) / 1e9,
        busy_s=busy_s,
        kernel_s=kernel_s,
        upload_s=upload_s,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=name_gaps(idle, sample_ns, sample_names),
    )


def kernel_seconds(events: Sequence[DeviceEvent]) -> float:
    """Device seconds of the kernels among ``events`` (copies and sets
    left out)."""
    return sum((e.end_ns - e.start_ns) / 1e9 for e in events if not is_copy(e.name))
