"""The rules by which two runs of an LM are held to agree.

Used where the port is compared with the JAX package (the differential
tests) and where the card is compared with the CPU (``chip_smoke.py``):

* logits in f32 within atol 1e-4 and rtol 1e-4, or, where larger, within
  the atol by which the reference's own logits move when every f32
  parameter moves by one ulp (:func:`ulp_perturbed`, :func:`f32_tolerance`):
  random-init models amplify round-off, and one run cannot be nearer
  another than the reference is to itself;
* decode steps against one full forward within the JAX package's own
  decode-parity tolerance (``tests/test_decode_long.py``);
* greedy tokens equal, except from a step where the reference's top-two
  margin is at most 1e-3, a near tie that round-off may break either way
  (:func:`greedy_agreement`).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

F32_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-3, rtol=1e-3)
GREEDY_MARGIN = 1e-3


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def ulp_perturbed(tree, seed: int = 9):
    """``tree`` (nested dicts of numpy arrays or tensors) with every f32
    leaf moved by one relative ulp (2^-24), up or down at random.

    Keys are visited in sorted order, the order of ``jax.tree.map``, so a
    tree draws the same signs whichever package walks it."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        a = _np(node)
        if a.dtype != np.float32:
            return node
        moved = np.asarray(a * (1 + rng.choice([-1, 1], a.shape) * 2.0 ** -24), np.float32)
        return torch.from_numpy(moved) if isinstance(node, torch.Tensor) else moved

    return walk(tree)


def f32_tolerance(want, moved) -> dict:
    """``assert_allclose`` keywords for logits against the reference's
    ``want``: :data:`F32_TOL`, with atol raised to ``max |moved - want|``
    where that is larger (``moved``: the reference's logits after
    :func:`ulp_perturbed`)."""
    sens = float(np.abs(_np(moved) - _np(want)).max())
    return dict(atol=max(F32_TOL["atol"], sens), rtol=F32_TOL["rtol"])


def top2_margin(logits, vocab_size: int) -> float:
    """The gap between the two largest of ``logits[:vocab_size]`` (1-D)."""
    top = np.sort(_np(logits).astype(np.float32)[:vocab_size])
    return float(top[-1] - top[-2])


def greedy_agreement(got, want, logits_at: Callable[[int, int], object], vocab_size: int,
                     margin: float = GREEDY_MARGIN) -> str:
    """Greedy tokens ``got`` ([B, n]) against the reference's ``want``.

    Each row must be equal, or first differ at a step ``t`` where the
    reference's top-two margin is at most ``margin``; ``logits_at(row, t)``
    gives the reference's last-position logits (1-D) after the prompt and
    ``want[row, :t]``. Raises ``AssertionError`` otherwise. Returns
    ``"equal"`` or a note of each near tie."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    notes = []
    for row in range(want.shape[0]):
        diff = np.flatnonzero(got[row] != want[row])
        if diff.size == 0:
            continue
        t = int(diff[0])
        gap = top2_margin(logits_at(row, t), vocab_size)
        if gap > margin:
            raise AssertionError(f"greedy row {row} step {t}: {int(got[row, t])} != reference "
                                 f"{int(want[row, t])} with a top-two margin of {gap:.3g}")
        notes.append(f"row {row} differs from step {t} (margin {gap:.2e})")
    return "; ".join(notes) or "equal"
