"""Spans of the port's host work, on the clock of the torch profiler's trace.

``with span("repro_torch.<layer>.<step>"):`` marks a stretch of the work as
one event of the torch profiler when one records, and as nothing when none
does: there is no environment variable, flag or argument. A span exists
exactly while a ``torch.profiler.profile`` (or the autograd profiler)
records, the switch that a benchmark's traced run and an operator already
use. Unprofiled, a span costs one check and hands back one shared no-op
context manager.

* Every name starts with ``repro_torch.``.
* A span's parent is the span that encloses it on the same thread. The
  spans of one call share its root span (``repro_torch.decompose``,
  ``repro_torch.bucketize``), which identifies the call.
* The spans are the profiler's own in-memory host events, with its
  timestamps, written out with the rest of the trace when the profile ends
  (``prof.profiler.kineto_results.events()``, ``export_chrome_trace``).
  The device events of the same trace are on the same clock, so a span can
  be set against the device's busy and idle intervals without an offset.

A span is recorded at the profiler's function scope
(``torch._C._profiler._RecordFunctionFast``), not as a user annotation
(``torch.profiler.record_function``): the profiler mirrors a user
annotation onto the device's timeline as an event spanning the kernels it
enclosed, which a reader of the device events would count as device work,
and it costs several times as much on the host. A span here is a host
event alone.
Both guarded calls, ``torch.autograd._profiler_enabled`` and
``_RecordFunctionFast``, are private torch APIs; ``tests/test_torch_trace.py``
pins what this module relies on.
"""
from __future__ import annotations

import contextlib
import functools

import torch

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` (which starts with
    :data:`PREFIX`) as a host event of the profiler that records, or does
    nothing when none records."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def spanned(name: str):
    """A decorator: every call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
