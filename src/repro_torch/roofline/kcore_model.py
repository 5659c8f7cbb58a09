"""Roofline cost model for the k-core conquer sweep.

Per-bucket HBM bytes and
compare-FLOPs for one sweep, in both the unfused multi-dispatch form
(gather materialized, dirty push re-reads the neighbor tile) and the fused
single-kernel form (``kernels.fused`` — the neighbor tile is read once, no
gathered intermediate ever hits HBM). ``core.decompose`` accumulates these
per live sweep from the active-frontier mask, so a run reports modeled
achieved-vs-roofline bandwidth next to its wall time (fig17), and the
opt-in int16 estimate mode shows up as a measured bytes-moved reduction
(``wire_bytes=2``).

The model counts traffic, not cache luck: every operand is charged one trip
at its natural width. FLOPs are the suffix-count compares (one op per
neighbor-slot x candidate), the term that dominates Algorithm 2.

The byte and FLOP counts are the JAX package's model unchanged, so both
packages report the same ``sweep_bytes_per_iter`` / ``sweep_flops_per_iter``.
Only the pricing differs: on Hopper the compares are int32 ops on the CUDA
cores, so :func:`roofline_time_s` prices them at ``hw.PEAK_INT32_OPS``.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from repro_torch.roofline import hw


def sweep_tile_cost(
    rows: int,
    width: int,
    cand: int,
    *,
    wire_bytes: int = 4,
    fused: bool = True,
    track_dirty: bool = True,
) -> Tuple[int, int]:
    """(HBM bytes, compare FLOPs) for one ``[rows, width]`` bucket sweep.

    ``wire_bytes`` is the estimate dtype width (4, or 2 in int16 mode):
    the gathered neighbor estimates and the current/new estimate rows move
    at that width; ids/ext stay 4-byte. ``cand`` is clamped to ``width``
    exactly as the kernels clamp it.
    """
    cand = max(1, min(int(cand), int(width)))
    neigh = rows * width * 4                 # neighbor-id tile, read once
    gather = rows * width * wire_bytes       # gathered estimates (c reads)
    row_io = rows * (4 + 4 + 2 * wire_bytes + 4)  # ids + ext + cur/est + changed
    push = rows * width * 1 if track_dirty else 0  # int8 dirty contributions
    nbytes = neigh + gather + row_io + push
    if not fused:
        # Multi-dispatch sweep: the [rows, width] gathered matrix is
        # materialized (store + re-load by the h-index), and the dirty
        # scatter-max re-reads the neighbor-id tile a second time.
        nbytes += 2 * rows * width * 4
        if track_dirty:
            nbytes += rows * width * 4
    flops = rows * width * cand + rows * cand  # compares + feasibility
    return int(nbytes), int(flops)


def sweep_cost(
    shapes: Iterable[Sequence[int]],
    cand: int,
    *,
    wire_bytes: int = 4,
    fused: bool = True,
    track_dirty: bool = True,
) -> Tuple[int, int]:
    """Sum :func:`sweep_tile_cost` over ``(rows, width)`` bucket shapes."""
    tb = tf = 0
    for rows, width in shapes:
        b, f = sweep_tile_cost(
            rows, width, cand, wire_bytes=wire_bytes, fused=fused,
            track_dirty=track_dirty,
        )
        tb += b
        tf += f
    return tb, tf


def roofline_time_s(
    nbytes: int,
    flops: int,
    *,
    hbm_bw: float = hw.HBM_BW,
    peak_ops: float = hw.PEAK_INT32_OPS,
) -> float:
    """Roofline lower bound for one sweep on the H100."""
    return max(nbytes / hbm_bw, flops / peak_ops)


def achieved_bw_fraction(
    nbytes: int, wall_s: float, *, hbm_bw: float = hw.HBM_BW
) -> float:
    """Achieved fraction of the H100's HBM bandwidth for a measured wall."""
    if wall_s <= 0:
        return 0.0
    return (nbytes / wall_s) / hbm_bw
