"""EdgeStore-format edit log — the serving layer's update feed.

An :class:`EditLog` is an append-only on-disk log of edge edits in the
exact spill format :class:`~repro_torch.graph.io.EdgeStore` uses — canonicalized
directed slots as interleaved ``(u, v)`` int64 pairs — split across two
streams (``ins.i64`` / ``del.i64``, each a verbatim ``slots.i64``). A
third file, ``frames.i64``, holds the batch framing: per sealed batch, the
cumulative slot counts of both streams as two int64s, written AFTER the
slot bytes are flushed, so a reader never observes a frame whose payload is
still in flight.

``EditLogReader`` tails the log: :meth:`poll` reports sealed-but-unread
batches, :meth:`read_batch` returns the next one as an
:class:`~repro_torch.graph.delta.EdgeEdits` (payload read in bounded chunks —
same ``chunk_slots`` discipline as ``EdgeStore.iter_slots``). Writer and
reader may live in different threads or processes; the framing file is the
only coordination point.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import numpy as np

from repro_torch.graph.build import canonical_slots
from repro_torch.graph.delta import EdgeEdits

_FRAME_WORDS = 2  # per sealed batch: cumulative (ins_slots, del_slots)


class EditLog:
    """Append-only edit-log writer (EdgeStore slot format + batch frames)."""

    def __init__(self, workdir: Optional[str] = None):
        self._own_dir = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(prefix="editlog_")
        os.makedirs(self.workdir, exist_ok=True)
        self.ins_path = os.path.join(self.workdir, "ins.i64")
        self.del_path = os.path.join(self.workdir, "del.i64")
        self.frames_path = os.path.join(self.workdir, "frames.i64")
        self._ins = open(self.ins_path, "wb")
        self._del = open(self.del_path, "wb")
        self._frames = open(self.frames_path, "wb")
        self.ins_slots = 0
        self.del_slots = 0
        self.n_batches = 0

    def _spill(self, f, src, dst) -> int:
        u, v = canonical_slots(
            np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64)
        )
        if u.size:
            pairs = np.empty(2 * u.size, dtype=np.int64)
            pairs[0::2] = u
            pairs[1::2] = v
            pairs.tofile(f)
        return int(u.size)

    def append(self, src, dst, *, delete: bool = False) -> None:
        """Canonicalize and spill one edit chunk into the open batch."""
        if delete:
            self.del_slots += self._spill(self._del, src, dst)
        else:
            self.ins_slots += self._spill(self._ins, src, dst)

    def seal_batch(self) -> int:
        """Close the open batch: flush payload, then write its frame.

        Returns the sealed batch's index. Sealing an empty batch is legal
        (an idle churn tick); readers see it as a no-op batch.
        """
        self._ins.flush()
        self._del.flush()
        os.fsync(self._ins.fileno())
        os.fsync(self._del.fileno())
        np.array([self.ins_slots, self.del_slots], dtype=np.int64).tofile(
            self._frames
        )
        self._frames.flush()
        self.n_batches += 1
        return self.n_batches - 1

    @property
    def spill_bytes(self) -> int:
        return (self.ins_slots + self.del_slots) * 16

    def cleanup(self) -> None:
        for f in (self._ins, self._del, self._frames):
            if not f.closed:
                f.close()
        if self._own_dir:
            shutil.rmtree(self.workdir, ignore_errors=True)

    def __enter__(self) -> "EditLog":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()


def _read_slot_range(
    path: str, lo_slot: int, hi_slot: int, chunk_slots: int
) -> tuple[np.ndarray, np.ndarray]:
    """Slots ``[lo, hi)`` of a slot file, read in bounded chunks."""
    n = hi_slot - lo_slot
    u = np.empty(n, dtype=np.int64)
    v = np.empty(n, dtype=np.int64)
    chunk_slots = max(1, int(chunk_slots))
    with open(path, "rb") as f:
        f.seek(lo_slot * 16)
        done = 0
        while done < n:
            want = min(chunk_slots, n - done)
            buf = np.fromfile(f, dtype=np.int64, count=2 * want)
            if buf.size < 2 * want:
                raise IOError(
                    f"edit log truncated: {path} ends before sealed frame"
                )
            u[done:done + want] = buf[0::2]
            v[done:done + want] = buf[1::2]
            done += want
    return u, v


class EditLogReader:
    """Tail an :class:`EditLog` directory batch by batch."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.ins_path = os.path.join(workdir, "ins.i64")
        self.del_path = os.path.join(workdir, "del.i64")
        self.frames_path = os.path.join(workdir, "frames.i64")
        self._cursor = 0           # next batch index to read
        self._ins_done = 0         # slots consumed so far
        self._del_done = 0

    def _frames(self) -> np.ndarray:
        if not os.path.exists(self.frames_path):
            return np.zeros((0, _FRAME_WORDS), dtype=np.int64)
        raw = np.fromfile(self.frames_path, dtype=np.int64)
        n = raw.size // _FRAME_WORDS  # a torn trailing frame is not sealed
        return raw[: n * _FRAME_WORDS].reshape(n, _FRAME_WORDS)

    def poll(self) -> int:
        """Number of sealed batches not yet read."""
        return max(0, self._frames().shape[0] - self._cursor)

    def read_batch(self, chunk_slots: int = 1 << 20) -> Optional[EdgeEdits]:
        """Next sealed batch as raw directed slots (``None`` if none)."""
        frames = self._frames()
        if self._cursor >= frames.shape[0]:
            return None
        ins_hi, del_hi = int(frames[self._cursor, 0]), int(frames[self._cursor, 1])
        iu, iv = _read_slot_range(
            self.ins_path, self._ins_done, ins_hi, chunk_slots
        )
        du, dv = _read_slot_range(
            self.del_path, self._del_done, del_hi, chunk_slots
        )
        self._ins_done, self._del_done = ins_hi, del_hi
        self._cursor += 1
        return EdgeEdits(ins_src=iu, ins_dst=iv, del_src=du, del_dst=dv)
