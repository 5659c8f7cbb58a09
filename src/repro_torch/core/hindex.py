"""H-index operators -- paper Algorithms 1 and 2, vectorized in PyTorch.

Algorithm 1 (Montresor et al. node index): given the previous-iteration
estimates of a node's neighbors, the new estimate is the largest ``h`` such
that at least ``h`` neighbors have estimate ``>= h``.

Algorithm 2 (this paper): with external information ``E(v)`` (the count of
neighbors in the already-finalized upper part), the new estimate is
``E(v) + max{ i : at least i in-part neighbors have estimate >= E(v) + i }``.
Algorithm 1 is the special case ``E(v) = 0``.

Two equivalent tensor forms (the ``"sorted"`` and ``"count"`` engines):

* :func:`hindex_sorted` -- sort each row descending and count the all-true
  prefix of ``row[i] >= E + i + 1`` (exactly the paper's loop).
* :func:`hindex_count` -- suffix-count form with no sort:
  ``cnt(i) = #{u : c(u) >= E + i}``, answer ``E + max{i : cnt(i) >= i}``.

Both operate on padded dense rows whose pad slots hold ``-1`` (never >= any
threshold, since estimates are >= 0). :func:`hindex_of_sequence` and
:func:`hindex_brute` are numpy, as in the JAX package;
:func:`hindex_of_tensor` is :func:`hindex_of_sequence` on a tensor's own
device, which ``decompose`` runs on the start values it has uploaded and
reads back in its set-up's one read, together with the int16 guard's
largest start value.
"""
from __future__ import annotations

import numpy as np
import torch


def hindex_sorted(neigh_cores: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """Paper Algorithm 2 via descending sort. ``neigh_cores``: [n, d] (-1 pad).

    Returns [n] int32 new estimates.
    """
    n, d = neigh_cores.shape
    cores = torch.sort(neigh_cores, dim=1, descending=True).values
    i = torch.arange(d, dtype=neigh_cores.dtype, device=neigh_cores.device)
    # Paper line 6: while Cores(i) >= E + i + 1 -> i++. New estimate = E + i
    # at the first violation (or E + len if none).
    ok = cores >= (ext[:, None] + i[None, :] + 1)
    prefix = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    return (ext + prefix).to(torch.int32)


def hindex_count(neigh_cores: torch.Tensor, ext: torch.Tensor,
                 cand_chunk: int = 256) -> torch.Tensor:
    """Paper Algorithm 2 via suffix counts (sort-free, chunked candidates).

    For candidate index i in [1, d]: value = E + i is feasible iff at least i
    neighbors have estimate >= E + i. The answer is E + (largest feasible i).
    Candidates are processed in chunks of ``cand_chunk`` to bound the
    [n, d, chunk] compare footprint.
    """
    n, d = neigh_cores.shape
    best = torch.zeros(n, dtype=torch.int32, device=neigh_cores.device)
    for lo in range(0, d, cand_chunk):
        w = min(cand_chunk, d - lo)
        i = (lo + 1) + torch.arange(w, dtype=neigh_cores.dtype,
                                    device=neigh_cores.device)  # [w]
        thr = ext[:, None] + i[None, :]  # [n, w]
        cnt = (neigh_cores[:, :, None] >= thr[:, None, :]).sum(dim=1)  # [n, w]
        feasible = cnt >= i[None, :]
        best_chunk = torch.where(feasible, i[None, :], 0).amax(dim=1)
        best = torch.maximum(best, best_chunk.to(torch.int32))
    return (ext + best).to(torch.int32)


def hindex_of_sequence(values: np.ndarray) -> int:
    """H-index of a host value sequence: max h with at least h values >= h.

    Used as the *candidate-window bound*: per part, no h-index offset ``i``
    can ever be feasible beyond ``hindex_of_sequence(deg + ext)`` -- a node
    would need ``i`` neighbors whose estimates (<= deg+ext at all times)
    reach ``ext_v + i >= i``. For ext=0 this is the classic degeneracy bound
    (k_max <= h-index of the degree sequence). This is what lets the kernels
    shrink the candidate axis from the bucket width to ~k_max with zero loss
    of exactness.
    """
    v = np.sort(np.asarray(values, dtype=np.int64))[::-1]
    i = np.arange(1, v.size + 1)
    ok = v >= i
    return int(i[ok].max(initial=0))


def hindex_of_tensor(values: torch.Tensor) -> torch.Tensor:
    """:func:`hindex_of_sequence` of a 1-D integer tensor, on its device.

    Returns a 0-d int64 tensor on ``values.device`` and reads nothing back,
    so a caller can bring it to the host in a read it makes anyway. The
    predicate ``#{v >= x} >= x`` holds for every ``x`` up to the h-index and
    for none above it, so the h-index is built bit by bit from the top: a
    bit stays set where the count at the value with it set still reaches
    that value. Each of the ``n.bit_length()`` bits (the h-index is at most
    ``n``) is one compare and one int32 sum over the values: no sort, no
    atomics, 5 bytes of scratch a value (the compare's bools and the int32
    copy the sum reads; an int64 sum would copy 8).
    """
    h = torch.zeros((), dtype=torch.int64, device=values.device)
    for bit in reversed(range(values.numel().bit_length())):
        t = h + (1 << bit)
        h = torch.where((values >= t).sum(dtype=torch.int32) >= t, t, h)
    return h


def hindex_brute(neigh_cores: np.ndarray, ext: int) -> int:
    """Literal transcription of paper Algorithm 2 (scalar; tests only)."""
    cores = sorted([c for c in neigh_cores.tolist() if c >= 0], reverse=True)
    i = 0
    c_v = ext + len(cores)
    while i < len(cores):
        if cores[i] >= ext + i + 1:
            i += 1
        else:
            c_v = ext + i
            break
    return int(c_v)
