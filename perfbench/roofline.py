"""The least time of one full sweep, by the benchmark's own arithmetic.

A full sweep of the h-index fixed point must, whatever implements it,
read every neighbour id of the CSR once and, for every node with a
neighbour, gather its estimate once, read its external information once
and write its new estimate once. Estimates are counted at the narrowest
width their start values (``deg + ext``) fit: 2 bytes when every start is
under ``2**15``, else 4. Neighbour ids and external information are int32.
Anything a sweep moves beyond that (padding, re-reads, dirty bits, counts)
is the implementation's cost and lowers its share.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB: published HBM3 bandwidth (data sheet).
HBM_BYTES_PER_S = 3.35e12

INT16_LIMIT = 1 << 15


def estimate_bytes(max_start: int) -> int:
    """Bytes of one estimate whose start values are at most ``max_start``."""
    return 2 if max_start < INT16_LIMIT else 4


def full_sweep_bytes(n_slots: int, n_active: int, max_start: int) -> int:
    """Least bytes of one full sweep: ``n_slots`` neighbour ids (both
    directions of every edge), ``n_active`` nodes with a neighbour."""
    w = estimate_bytes(max_start)
    return 4 * int(n_slots) + int(n_active) * (w + 4 + w)


def share_percent(least_bytes: int, kernel_seconds: float) -> float:
    """The sweep's share of its roofline: least time over device time."""
    return 100.0 * (least_bytes / HBM_BYTES_PER_S) / kernel_seconds
