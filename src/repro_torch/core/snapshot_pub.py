"""Double-buffered coreness snapshot publication + batched query serving.

The serving shape is alloc/swap: the update thread builds the next
:class:`CorenessSnapshot` COMPLETELY off to the side (fresh arrays, marked
read-only), then publishes it with a single reference assignment — the one
atomic pointer flip readers ever observe. Query threads grab
``self._front`` once per query and work off that object; they either see
the old snapshot or the new one in full, never a mix. No locks sit on the
query path; the publish lock only serializes writers.

Torn-state detection is built into the snapshot: ``checksum`` is derived
from the coreness payload at build time, and :meth:`CorenessSnapshot.
verify` recomputes it — the serve test hammers queries during swaps and
asserts every observed snapshot self-verifies and carries monotonically
non-decreasing versions.

Metrics (:meth:`SnapshotPublisher.metrics`): publishes/sec and edits/sec
over the process lifetime, query p50/p99 latency over a bounded window,
and staleness — how many edits were pending (drained from the log but not
yet published, plus sealed-but-undrained if the caller reports them) at
the moment each query ran.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.graph.structs import Graph


def _payload_checksum(coreness: np.ndarray, version: int) -> int:
    """Cheap order-sensitive digest of the published payload."""
    c = coreness.astype(np.uint64, copy=False)
    idx = np.arange(1, c.size + 1, dtype=np.uint64)
    salt = np.uint64((version * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
    return int((c * idx).sum(dtype=np.uint64) ^ salt)


@dataclasses.dataclass(frozen=True)
class CorenessSnapshot:
    """One immutable published state: graph + exact coreness + provenance."""

    graph: Graph
    coreness: np.ndarray  # int32, original-id order, read-only
    version: int
    checksum: int
    published_at: float  # perf_counter stamp, for staleness-age metrics

    @property
    def n_nodes(self) -> int:
        return int(self.coreness.size)

    @property
    def max_core(self) -> int:
        return int(self.coreness.max(initial=0))

    def verify(self) -> bool:
        """Recompute the payload digest — False means a torn/corrupt read."""
        return _payload_checksum(self.coreness, self.version) == self.checksum


class SnapshotPublisher:
    """Single-writer / many-reader coreness snapshot exchange."""

    def __init__(self, latency_window: int = 4096):
        self._front: Optional[CorenessSnapshot] = None
        self._publish_lock = threading.Lock()
        self._version = 0
        self._t_start = time.perf_counter()
        self._n_publishes = 0
        self._n_edits_published = 0
        self._pending_lock = threading.Lock()
        self._pending_edits = 0
        self._query_lat_s: deque = deque(maxlen=latency_window)
        self._query_staleness: deque = deque(maxlen=latency_window)
        self._n_queries = 0

    # -- writer side -----------------------------------------------------

    def publish(
        self, graph: Graph, coreness: np.ndarray, n_edits: int = 0
    ) -> CorenessSnapshot:
        """Build and flip in a new snapshot; returns it.

        ``coreness`` is copied into a fresh read-only buffer first (the
        alloc of alloc/swap — the caller may keep mutating its array), the
        snapshot is assembled completely, and only then does the single
        reference assignment make it visible.
        """
        with self._publish_lock:
            self._version += 1
            version = self._version
            payload = np.array(coreness, dtype=np.int32, copy=True)
            payload.setflags(write=False)
            snap = CorenessSnapshot(
                graph=graph,
                coreness=payload,
                version=version,
                checksum=_payload_checksum(payload, version),
                published_at=time.perf_counter(),
            )
            self._front = snap  # the atomic pointer flip
            self._n_publishes += 1
            self._n_edits_published += int(n_edits)
            if n_edits:
                with self._pending_lock:
                    self._pending_edits = max(0, self._pending_edits - int(n_edits))
        return snap

    def note_pending(self, n_edits: int) -> None:
        """Report edits seen in the log but not yet folded into a publish."""
        with self._pending_lock:
            self._pending_edits += int(n_edits)

    # -- reader side -----------------------------------------------------

    @property
    def snapshot(self) -> Optional[CorenessSnapshot]:
        """The current front snapshot (None before the first publish)."""
        return self._front

    def _serve(self, fn):
        snap = self._front
        if snap is None:
            raise RuntimeError("no snapshot published yet")
        t0 = time.perf_counter()
        out = fn(snap)
        self._query_lat_s.append(time.perf_counter() - t0)
        self._query_staleness.append(self._pending_edits)
        self._n_queries += 1
        return out

    def query_coreness(self, node_ids) -> np.ndarray:
        """Batched coreness lookup; out-of-range ids answer 0 (unknown)."""
        def run(snap):
            ids = np.asarray(node_ids, dtype=np.int64)
            out = np.zeros(ids.shape, dtype=np.int32)
            ok = (ids >= 0) & (ids < snap.n_nodes)
            out[ok] = snap.coreness[ids[ok]]
            return out
        return self._serve(run)

    def query_kcore_members(self, k: int) -> np.ndarray:
        """Node ids of the k-core (coreness >= k), ascending."""
        return self._serve(
            lambda snap: np.nonzero(snap.coreness >= int(k))[0].astype(np.int64)
        )

    def query_top_kcore(self) -> tuple[int, np.ndarray]:
        """(k_max, member ids of the innermost non-empty core)."""
        def run(snap):
            k = snap.max_core
            return k, np.nonzero(snap.coreness >= k)[0].astype(np.int64)
        return self._serve(run)

    def query_in_kcore(self, node_ids, k: int) -> np.ndarray:
        """Batched k-core membership test."""
        def run(snap):
            ids = np.asarray(node_ids, dtype=np.int64)
            out = np.zeros(ids.shape, dtype=bool)
            ok = (ids >= 0) & (ids < snap.n_nodes)
            out[ok] = snap.coreness[ids[ok]] >= int(k)
            return out
        return self._serve(run)

    # -- metrics ---------------------------------------------------------

    def metrics(self) -> dict:
        lat = np.asarray(self._query_lat_s, dtype=np.float64)
        stale = np.asarray(self._query_staleness, dtype=np.float64)
        dt = max(1e-9, time.perf_counter() - self._t_start)
        return {
            "n_publishes": self._n_publishes,
            "n_edits_published": self._n_edits_published,
            "updates_per_s": self._n_edits_published / dt,
            "publishes_per_s": self._n_publishes / dt,
            "n_queries": self._n_queries,
            "pending_edits": self._pending_edits,
            "query_p50_ms": float(np.percentile(lat, 50) * 1e3) if lat.size else 0.0,
            "query_p99_ms": float(np.percentile(lat, 99) * 1e3) if lat.size else 0.0,
            "staleness_mean_edits": float(stale.mean()) if stale.size else 0.0,
            "staleness_max_edits": float(stale.max()) if stale.size else 0.0,
            "version": self._version,
        }
