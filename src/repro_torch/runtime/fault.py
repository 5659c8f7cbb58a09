"""Fault tolerance utilities: failure injection and idempotent retries.

A copy of the JAX package's ``repro.runtime.fault`` (pure Python, no
framework), so a fault spec parses and fires the same way in both
packages. Every part of the divide step is an idempotent sub-task over
immutable inputs, so a failed part is re-run without touching finished
parts (the paper's 27.5 h WX-136B run is a sequence of such parts);
``run_with_retries`` is the standalone form of that discipline.

:class:`FaultPlan` is the chaos-engineering half: a declarative plan of
crashes, hangs and slowdowns injected into *named sites* of the pipeline
(``slice_conquer``, ``boundary_fold``, ``checkpoint_save``, ``prefetch``,
``serve_update``). Production code calls ``plan.visit(site)`` at each site
-- a no-op unless the plan armed a fault there -- so the chaos tests and
the CLIs (``--fault``) share one mechanism. Injected hangs park on an
Event with a bounded timeout and then raise, so an abandoned worker thread
always terminates (the test suite's thread-leak gate stays sound under
chaos). ``slice_conquer`` is visited by the part-parallel wave executor
(:func:`repro_torch.core.partsched.conquer_wave`) before each attempt of a
part on a slice; with the watchdog armed a fault there is retried or
re-planned in the run, while the other sites are fail-fast.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence, Set

# Sites known to the pipeline. visit() accepts any name (a plan targeting
# an unknown site simply never fires), but the CLI validates against this
# list to catch typos in --fault.
FAULT_SITES = (
    "slice_conquer",    # conquer_wave: one part's conquer on a slice worker
    "boundary_fold",    # dckcore: E(v) boundary fold after a part finishes
    "checkpoint_save",  # dckcore: part-boundary pipeline-state save
    "prefetch",         # dckcore: background extract/bucketize worker
    "serve_update",     # kcore_serve: incremental update-worker batch
)


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raise at the given steps — once each (simulated worker loss)."""

    fail_at: Set[int]
    raised: Set[int] = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.raised:
            self.raised.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


def run_with_retries(fn: Callable, retries: int = 2, backoff_s: float = 0.0,
                     on_retry: Optional[Callable] = None):
    """Run an idempotent sub-task, retrying on failure."""
    last = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — deliberate catch-all boundary
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff_s:
                time.sleep(backoff_s * (attempt + 1))
    raise last


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: ``kind`` at the ``at``-th visit of ``site``.

    ``kind``: ``crash`` raises :class:`InjectedFailure`; ``hang`` parks the
    visiting thread until released (or ``delay_s`` elapses, then raises —
    a hang never outlives the run); ``slow`` sleeps ``delay_s`` and
    returns. ``at`` counts visits to the site from 0; ``count`` visits
    starting there fire (so ``at=0, count=10**9`` ≈ "every visit").
    """

    site: str
    kind: str = "crash"  # crash | hang | slow
    at: int = 0
    count: int = 1
    delay_s: float = 30.0

    def __post_init__(self):
        if self.kind not in ("crash", "hang", "slow"):
            raise ValueError(f"unknown fault kind {self.kind!r}")

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """Parse the CLI form ``site:kind[:at[:count[:delay_s]]]``."""
        parts = text.split(":")
        if not 2 <= len(parts) <= 5:
            raise ValueError(
                f"bad fault spec {text!r} — want site:kind[:at[:count[:delay_s]]]"
            )
        site, kind = parts[0], parts[1]
        if site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {site!r} — known sites: {', '.join(FAULT_SITES)}"
            )
        at = int(parts[2]) if len(parts) > 2 else 0
        count = int(parts[3]) if len(parts) > 3 else 1
        delay = float(parts[4]) if len(parts) > 4 else 30.0
        return cls(site=site, kind=kind, at=at, count=count, delay_s=delay)


class FaultPlan:
    """Declarative chaos: inject faults into named pipeline sites.

    Thread-safe — sites are visited from slice workers, checkpoint
    threads and the prefetcher concurrently. Each injection (and each
    visit-counter advance for a site that fires) is recorded in
    ``events`` for the fault-event log the CI chaos leg uploads.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs = list(specs)
        self.events: List[dict] = []
        self._visits: dict = {}
        self._lock = threading.Lock()
        # Set when the owning run abandons injected hangs: parked threads
        # wake and raise, so they can never outlive the run.
        self._release = threading.Event()

    @classmethod
    def parse(cls, texts: Sequence[str]) -> "FaultPlan":
        return cls([FaultSpec.parse(t) for t in texts])

    def release(self):
        """Wake every thread parked in an injected hang (it then raises)."""
        self._release.set()

    def _record(self, kind: str, **ctx):
        self.events.append({"event": "inject", "kind": kind, **ctx})

    def visit(self, site: str, **ctx) -> None:
        """Pass through the named site; inject a fault if one is armed.

        ``ctx`` (cursor, slice, attempt, ...) is stamped into the event
        log. Crash/hang raise :class:`InjectedFailure`; slow sleeps.
        """
        with self._lock:
            n = self._visits.get(site, 0)
            self._visits[site] = n + 1
            hit = None
            for spec in self.specs:
                if spec.site == site and spec.at <= n < spec.at + spec.count:
                    hit = spec
                    break
            if hit is not None:
                self._record(hit.kind, site=site, visit=n, **ctx)
        if hit is None:
            return
        if hit.kind == "crash":
            raise InjectedFailure(f"injected crash at {site} (visit {n})")
        if hit.kind == "slow":
            time.sleep(hit.delay_s)
            return
        # hang: park until released or delay_s elapses — then raise, so an
        # abandoned (blacklisted) worker thread always terminates.
        self._release.wait(timeout=hit.delay_s)
        raise InjectedFailure(f"injected hang at {site} (visit {n}) ended")

    def visits(self, site: str) -> int:
        with self._lock:
            return self._visits.get(site, 0)
