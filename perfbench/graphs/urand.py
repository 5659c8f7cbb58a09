"""GAP's "urand" graph: both endpoints of every edge uniform at random.

``edge_factor * 2**scale`` edges over ``2**scale`` nodes (the Erdos-Renyi
shape GAP's ``MakeUniformEL`` draws). Self-loops and duplicates stay in
the list; the CSR build drops them.
"""
from __future__ import annotations

import torch


def edges(scale: int, edge_factor: int, params: dict, generator: torch.Generator,
          device: torch.device):
    """``(src, dst)`` int64 tensors on ``device``, drawn from ``generator``."""
    n = 1 << scale
    m = n * edge_factor
    src = torch.randint(0, n, (m,), generator=generator, device=device)
    dst = torch.randint(0, n, (m,), generator=generator, device=device)
    return src, dst
