"""The partial-counts kernel of the distributed engine: CUDA wrapper and plain
version.

:func:`partial_counts_op` launches ``csrc/counts.cu`` for CUDA tensors and
runs :func:`partial_counts_plain` for CPU tensors; it never falls back from
one to the other. :func:`partial_counts_plain` transcribes the JAX
package's oracle (``repro/kernels/counts/ref.py``): per row, the suffix
counts over the LOCAL neighbour-slot shard

    cnt[r, i] = #{j : x[r, j] >= ext[r] + i + 1},  i in [0, cand)

the payload the distributed engine sums over the slot shards before its
feasibility argmax. Unlike the h-index kernels, ``cand`` is not clamped
to the width: a slot shard's counts are only one term of the sum.
"""
from __future__ import annotations

import ctypes

import torch

# The plain version materializes at most this many [row, slot, candidate]
# compares at a time (rows and candidates are chunked), so hub widths stay
# within memory.
_PLAIN_CHUNK = 1 << 27

_fn = None


def partial_counts_plain(x: torch.Tensor, ext: torch.Tensor, *, cand: int) -> torch.Tensor:
    """Plain PyTorch suffix counts. ``x``: [rows, width] (-1 pad), ``ext``:
    [rows]; returns [rows, cand] int32."""
    rows, width = x.shape
    cand = int(cand)
    x = x.to(torch.int32)
    ext = ext.to(torch.int32)
    out = torch.empty(rows, cand, dtype=torch.int32, device=x.device)
    w = max(width, 1)
    c_step = max(1, min(cand, _PLAIN_CHUNK // w))
    r_step = max(1, _PLAIN_CHUNK // (w * c_step))
    for lo in range(0, rows, r_step):
        xs, es = x[lo : lo + r_step], ext[lo : lo + r_step]
        for c_lo in range(0, cand, c_step):
            c_hi = min(cand, c_lo + c_step)
            i = torch.arange(c_lo + 1, c_hi + 1, dtype=torch.int32, device=x.device)
            thr = es[:, None] + i[None, :]  # [r, chunk]
            out[lo : lo + r_step, c_lo:c_hi] = (
                xs[:, :, None] >= thr[:, None, :]).sum(dim=1, dtype=torch.int32)
    return out


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load

        fn = load("counts").kcore_partial_counts
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def partial_counts_op(x: torch.Tensor, ext: torch.Tensor, *, cand: int) -> torch.Tensor:
    """Suffix counts of one slot shard of a bucket: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    Args:
      x: [rows, w_local] int32 gathered neighbour estimates, pad slots -1.
      ext: [rows] int32 external information.
      cand: candidate window (>= 1; not clamped to ``w_local``).
    Returns:
      [rows, cand] int32 counts, exactly ``rows`` rows (no padding).

    Every kernel launch adds one to ``partial_counts_op.launches``.
    """
    if x.dim() != 2 or ext.shape != (x.shape[0],):
        raise ValueError(f"partial_counts_op: x {tuple(x.shape)} / ext "
                         f"{tuple(ext.shape)} must be [rows, width] / [rows]")
    if int(cand) < 1:
        raise ValueError(f"partial_counts_op: cand {cand} must be >= 1")
    if x.dtype != torch.int32 or ext.dtype != torch.int32:
        raise TypeError(f"partial_counts_op: x {x.dtype} / ext {ext.dtype} must be int32")
    if x.device.type == "cpu" and ext.device.type == "cpu":
        return partial_counts_plain(x, ext, cand=cand)
    if x.device.type != "cuda" or ext.device != x.device:
        raise ValueError(f"partial_counts_op: x on {x.device}, ext on {ext.device}; "
                         f"both must be on one CUDA device (or both on the CPU)")
    if not (x.is_contiguous() and ext.is_contiguous()):
        raise ValueError("partial_counts_op: x and ext must be contiguous")
    rows, width = x.shape
    out = torch.empty(rows, int(cand), dtype=torch.int32, device=x.device)
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), ext.data_ptr(), out.data_ptr(),
                    rows, width, int(cand), stream)
    if err:
        raise RuntimeError(f"kcore_partial_counts launch failed with CUDA error {err}")
    partial_counts_op.launches += 1
    return out


partial_counts_op.launches = 0
