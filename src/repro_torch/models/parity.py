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
  (:func:`greedy_agreement`);
* training runs: every step's loss within rtol 1e-4, and the parameters
  after ``n`` steps by :func:`train_param_agreement`, a tolerance tied to
  the learning rate.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

F32_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-3, rtol=1e-3)
GREEDY_MARGIN = 1e-3
TRAIN_LOSS_RTOL = 1e-4
BF16_ROUNDING = 2.0 ** -7  # one rounding of a bf16 value, relative


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


def _is_bf16(x) -> bool:
    dtype = getattr(x, "dtype", None)  # a tensor, or a numpy array of ml_dtypes' bfloat16
    return dtype == torch.bfloat16 or getattr(dtype, "name", "") == "bfloat16"


def lr_budget(lr_fn, n_steps: int) -> float:
    """``2 * sum_t lr_t`` over the first ``n_steps`` steps of a schedule."""
    return 2 * sum(float(lr_fn(torch.tensor(s + 1.0))) for s in range(n_steps))


def train_param_agreement(got: dict, want: dict, lr_fn, n_steps: int) -> str:
    """Parameters after ``n_steps`` of training (``got``, dicts of arrays
    or tensors by name) against the reference run's ``want``.

    The gradients of the two runs agree to f32 round-off, so each update
    agrees to round-off too, except for an element whose gradient is itself
    at round-off level: there the optimizer's normalized direction (AdamW's
    ``mhat / sqrt(vhat)``, Adafactor's ``g / sqrt(v)``: +-1 at the first
    step, O(1) after) may point either way, and the two updates differ by up
    to ``2 * lr_t``. So every element must lie within :func:`lr_budget`, a
    bf16 parameter also within one bf16 rounding of its value (two sums a
    round-off apart may round to neighbouring bf16 values); and all but
    0.1% of the elements within a thousandth of that budget (beyond the
    bf16 rounding): sign flips are rare, round-off is not. Raises
    ``AssertionError``; returns a note of the largest difference."""
    budget = lr_budget(lr_fn, n_steps)
    worst, n_out, n_all = 0.0, 0, 0
    for name, w in want.items():
        g = got[name]
        rtol = BF16_ROUNDING if _is_bf16(g) or _is_bf16(w) else 0.0
        a, b = _np(g).astype(np.float64), _np(w).astype(np.float64)
        if a.shape != b.shape:
            raise AssertionError(f"{name}: shape {a.shape} against {b.shape}")
        excess = np.abs(a - b) - rtol * np.abs(b)
        if excess.size and excess.max() > budget:
            raise AssertionError(f"{name}: differs by {np.abs(a - b).max():.3e}, beyond the lr "
                                 f"budget {budget:.3e} (rtol {rtol:g})")
        worst = max(worst, float(np.abs(a - b).max(initial=0.0)))
        n_out += int((excess > budget * 1e-3).sum())
        n_all += a.size
    if n_out > 1e-3 * n_all:
        raise AssertionError(f"{n_out} of {n_all} elements differ by more than "
                             f"{budget * 1e-3:.3e} (a thousandth of the lr budget)")
    return (f"max abs diff {worst:.3e} (lr budget {budget:.3e}); {n_out} of {n_all:,} elements "
            f"beyond a thousandth of it")
