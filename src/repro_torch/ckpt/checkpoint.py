"""Atomic checkpoints of host arrays, in the JAX package's on-disk format.

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per tree leaf (path-
encoded file name) plus ``manifest.json`` (``step``, ``files``,
``dtypes``, per-leaf ``crc32``, ``treedef``, ``extra``). Writes go to
``step_<N>.tmp`` and are renamed only when complete, so a killed run never
leaves a half checkpoint. The format is the one ``repro.ckpt`` writes, so
a checkpoint taken by either package restores in the other.

A tree is a dict, list or tuple of numpy arrays (nested as deep as
needed); dicts flatten in sorted-key order and ``None`` holds no leaf, as
a JAX pytree does. Leaf file names are the ones the JAX package derives
from its key paths: ``coreness__0.npy`` for ``{"coreness": ...}``,
``0__0.npy`` for a list's first element, ``a_b__0.npy`` for
``{"a": {"b": ...}}``, ``leaf__0.npy`` for a bare array. Leaves are numpy
arrays or CPU torch tensors; a bf16 tensor (numpy has none without
``ml_dtypes``) is written as its 16-bit pattern under the dtype name
``bfloat16``, as the JAX package writes one, and restores as a bf16 tensor.

Integrity: :func:`save_pytree` stamps a CRC32 per leaf and
:func:`restore_pytree` re-checks it; bit rot, truncation or an unreadable
manifest raise :class:`CheckpointCorruptError`.
:func:`restore_pytree_with_fallback` quarantines a corrupt step
(``step_<N>.corrupt``) and falls back to the next-newest one.
:class:`CheckpointManager` adds retention (the ``retain`` newest steps)
and async saves with the JAX package's ordering contract: a save
snapshots the tree by value before returning, at most one save is in
flight, a worker failure re-raises on the next entry point, and
``clear_steps`` waits out a pending save before it purges.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# Worker threads of in-flight async saves carry this name prefix; the test
# suite asserts none outlive a test (a leaked thread = a missing wait()).
SAVE_THREAD_PREFIX = "ckpt-save"

# Default retention: the newest step plus one predecessor, so a corrupted
# latest step can fall back instead of restarting from scratch.
DEFAULT_RETAIN = 2


class CheckpointCorruptError(RuntimeError):
    """A checkpoint step failed integrity checks (CRC mismatch, unreadable
    leaf file, or a missing/undecodable manifest)."""


def _flatten(tree, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], object]]:
    """``(key path, leaf)`` pairs in JAX's flattening order. Path entries
    are the strings JAX prints for its keys: ``['k']`` for a dict key,
    ``[i]`` for a list or tuple index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (f"[{k!r}]",))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (f"[{i}]",))
        return out
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from the ``leaves`` iterator."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _treedef_str(tree) -> str:
    """The structure as JAX prints a ``PyTreeDef`` (kept in the manifest for
    people; restore does not read it)."""
    def rec(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {rec(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(rec(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(rec(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "None" if t is None else "*"
    return f"PyTreeDef({rec(tree)})"


def _leaf_files(tree):
    pairs = _flatten(tree)
    names = []
    for path, _leaf in pairs:
        name = "_".join(re.sub(r"[^A-Za-z0-9_]", "", p) for p in path)
        names.append(name or "leaf")
    # Disambiguate duplicates deterministically.
    seen: dict = {}
    out = []
    for n in names:
        k = seen.get(n, 0)
        seen[n] = k + 1
        out.append(f"{n}__{k}.npy")
    return out, [leaf for _path, leaf in pairs]


def _saved_array(leaf) -> Tuple[np.ndarray, str]:
    """The array written for a leaf, and the dtype name in the manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _loaded_leaf(arr: np.ndarray, dtype_name: str):
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype_name)  # numpy dtypes only (TypeError otherwise)
    return arr if arr.dtype == want else arr.view(want)


def _leaf_crc32(arr: np.ndarray) -> int:
    """CRC32 over the leaf's raw bytes, as serialized."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save_pytree(path: str, tree, step: int, extra: Optional[dict] = None) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    files, leaves = _leaf_files(tree)
    dtypes = []
    crcs = []
    for fname, leaf in zip(files, leaves):
        arr, dtype_name = _saved_array(leaf)
        dtypes.append(dtype_name)
        crcs.append(_leaf_crc32(arr))
        np.save(os.path.join(tmp, fname), arr)
    manifest = {
        "step": step,
        "files": files,
        "dtypes": dtypes,
        "crc32": crcs,
        "treedef": _treedef_str(tree),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(path)
        if (m := re.fullmatch(r"step_(\d+)", d))
    ]
    return max(steps) if steps else None


def restore_pytree(path: str, like, step: Optional[int] = None):
    """Restore into the structure of ``like``; returns ``(tree, step,
    extra)``.

    Integrity failures (unreadable manifest, unloadable leaf, CRC
    mismatch) raise :class:`CheckpointCorruptError`; a structure mismatch
    against ``like`` is a caller error and raises ``ValueError``."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest in {d}: {type(e).__name__}: {e}"
        ) from e
    files, _leaves = _leaf_files(like)
    if files != manifest["files"]:
        raise ValueError(f"checkpoint/template structure mismatch: {d} holds "
                         f"{manifest['files']}, the template has {files}")
    # Pre-CRC checkpoints (older layout) carry no crc32 list: load as-is.
    crcs = manifest.get("crc32") or [None] * len(files)
    arrays = []
    for fname, dtype_name, want_crc in zip(files, manifest["dtypes"], crcs):
        try:
            arr = np.load(os.path.join(d, fname))
        except Exception as e:  # noqa: BLE001 -- any load failure = corrupt
            raise CheckpointCorruptError(
                f"unreadable leaf {fname} in {d}: {type(e).__name__}: {e}"
            ) from e
        if want_crc is not None and _leaf_crc32(arr) != want_crc:
            raise CheckpointCorruptError(
                f"CRC mismatch for leaf {fname} in {d} (bit rot or torn write)"
            )
        arrays.append(_loaded_leaf(arr, dtype_name))
    return _unflatten(like, iter(arrays)), step, manifest["extra"]


def quarantine_step(path: str, step: int) -> str:
    """Rename ``step_<N>`` to ``step_<N>.corrupt`` (kept for postmortem).

    The quarantined dir no longer matches the step regex, so
    :func:`latest_step`, retention GC and restore all skip it; purge paths
    (``clear_steps``) still remove it."""
    d = os.path.join(path, f"step_{step:08d}")
    q = d + ".corrupt"
    if os.path.isdir(q):
        shutil.rmtree(q, ignore_errors=True)
    os.replace(d, q)
    return q


def restore_pytree_with_fallback(
    path: str,
    like,
    on_corrupt: Optional[Callable[[int, "CheckpointCorruptError"], None]] = None,
):
    """Restore the newest step that passes integrity checks.

    A corrupt step is quarantined (renamed ``.corrupt``), ``on_corrupt``
    is notified, and the next-newest retained step is tried. Raises
    ``FileNotFoundError`` when no intact step remains."""
    while True:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no intact checkpoints under {path}")
        try:
            return restore_pytree(path, like, step=step)
        except CheckpointCorruptError as exc:
            q = quarantine_step(path, step)
            logger.warning(
                "checkpoint step %d corrupt (%s) -- quarantined to %s, "
                "falling back to previous retained step", step, exc, q,
            )
            if on_corrupt is not None:
                on_corrupt(step, exc)


def _host_copy(tree):
    """The tree with every leaf copied into a fresh numpy array."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class CheckpointManager:
    """Retention plus async saves, one save in flight at a time.

    ``retain`` is the number of newest steps kept by the post-save GC
    (default 2, so a corrupted latest step can fall back to its
    predecessor). Save, wait and purge are serialized by a lock.
    """

    def __init__(self, path: str, retain: int = DEFAULT_RETAIN):
        self.path = path
        self.retain = retain
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.RLock()
        # Wall seconds of the last COMPLETED save (write + rename + GC), as
        # opposed to the time save()'s caller was blocked.
        self.last_save_seconds: float = 0.0
        os.makedirs(path, exist_ok=True)

    def save(
        self,
        tree,
        step: int,
        extra: Optional[dict] = None,
        blocking: bool = False,
        on_done: Optional[Callable[[int, float], None]] = None,
    ) -> float:
        """Save ``tree`` at ``step``; returns seconds the caller was blocked.

        Blocking: the return value is the full save. Async: it covers
        waiting out the previous save plus the by-value copy of the tree;
        the write's own duration lands in ``last_save_seconds`` and is
        passed to ``on_done(step, seconds)`` from the worker thread. A
        failure of the previous async save re-raises here."""
        with self._lock:
            t_blocked = time.perf_counter()
            self.wait()
            host_tree = _host_copy(tree)

            def work():
                t0 = time.perf_counter()
                try:
                    save_pytree(self.path, host_tree, step, extra)
                    self._gc()
                    self.last_save_seconds = time.perf_counter() - t0
                    if on_done is not None:
                        on_done(step, self.last_save_seconds)
                except BaseException as e:  # surfaced on the next entry point
                    self._error = e

            if blocking:
                work()
                self.wait()  # re-raise a failure immediately
            else:
                self._pending = threading.Thread(
                    target=work, daemon=True,
                    name=f"{SAVE_THREAD_PREFIX}:{os.path.basename(self.path)}:{step}",
                )
                self._pending.start()
            return time.perf_counter() - t_blocked

    def wait(self):
        """Join the in-flight save, re-raising any failure it hit."""
        with self._lock:
            if self._pending is not None:
                self._pending.join()
                self._pending = None
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def clear_steps(self):
        """Remove every step dir (``.tmp`` and ``.corrupt`` included) under
        ``path``, after waiting out the pending save (so a purge never
        removes a ``.tmp`` the worker is still filling)."""
        with self._lock:
            self.wait()
            if not os.path.isdir(self.path):
                return
            for d in os.listdir(self.path):
                if re.fullmatch(r"step_\d+(\.tmp|\.corrupt)?", d):
                    shutil.rmtree(os.path.join(self.path, d), ignore_errors=True)

    def _gc(self):
        steps = sorted(
            int(m.group(1))
            for d in os.listdir(self.path)
            if (m := re.fullmatch(r"step_(\d+)", d))
        )
        for s in steps[: -self.retain]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"), ignore_errors=True)
