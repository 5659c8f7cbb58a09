"""File-backed token loader with host sharding and background prefetch.

``MemmapTokens`` reads a flat int32 token file (np.memmap — no RAM copy of
the corpus), slices per (step, host) deterministically, and ``Prefetcher``
overlaps host IO with device compute via a bounded background queue —
the straggler-mitigation story for host-side input hiccups. A copy of the
JAX package's ``data/loader.py`` (numpy only).
"""
from __future__ import annotations

import queue
import threading
import numpy as np


class MemmapTokens:
    def __init__(self, path: str, seq_len: int, batch: int,
                 host_index: int = 0, host_count: int = 1):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.batch = batch
        self.host_index = host_index
        self.host_count = host_count
        self.tokens_per_step = seq_len + 1
        n_rows = len(self.data) // self.tokens_per_step
        self.rows_per_host = n_rows // host_count
        if self.rows_per_host < batch:
            raise ValueError("dataset too small for batch per host")

    def batch_at(self, step: int) -> dict:
        base = self.host_index * self.rows_per_host
        start = (step * self.batch) % (self.rows_per_host - self.batch + 1)
        rows = []
        for i in range(self.batch):
            r = base + start + i
            off = r * self.tokens_per_step
            rows.append(np.asarray(self.data[off : off + self.tokens_per_step]))
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


class Prefetcher:
    """Bounded background prefetch of ``source.batch_at(step)``."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.source.batch_at(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
