"""GAP's "kron" graph: Graph500 Kronecker edges with permuted labels.

Each of ``edge_factor * 2**scale`` edges picks one quadrant of the
adjacency matrix per bit of its endpoints, with probabilities
``a, b, c`` and ``1 - a - b - c`` (GAP's ``MakeKronEL``: a point under
``a + b`` leaves the source bit 0 and sets the destination bit above
``a``; otherwise the source bit is 1 and the destination bit is set above
``a + b + c``). The labels come out of this draw ordered by the
Kronecker bits; ``graph.make_csr`` permutes them at random, as GAP's
``PermuteIDs`` does, so that a node's id says nothing of its degree.
Self-loops and duplicates stay in the list; the CSR build drops them.
"""
from __future__ import annotations

import torch


def edges(scale: int, edge_factor: int, params: dict, generator: torch.Generator,
          device: torch.device):
    """``(src, dst)`` int64 tensors on ``device``, drawn from ``generator``."""
    n = 1 << scale
    m = n * edge_factor
    a, b, c = float(params["a"]), float(params["b"]), float(params["c"])
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        r = torch.rand(m, generator=generator, device=device)
        src_bit = r >= a + b
        dst_bit = torch.where(src_bit, r >= a + b + c, r >= a)
        del r
        src.mul_(2).add_(src_bit)
        dst.mul_(2).add_(dst_bit)
        del src_bit, dst_bit
    return src, dst
