"""The plain reference: exact coreness by level-synchronous peeling.

Plain PyTorch over a CSR, independent of the code under test (the port
iterates the h-index to a fixed point over bucketed tiles; this peels).
At level ``k`` every remaining node of degree at most ``k`` among the
remaining nodes is removed with coreness ``k``, and its removal lowers
its remaining neighbours' degrees; the level rises to the least remaining
degree when no node is left to remove at ``k``. That is the definition of
the k-core (the ``k``-core is what is left once every node of remaining
degree below ``k`` is gone), done a whole frontier at a time, so one
round costs work in the frontier's edges and the remaining node count.
"""
from __future__ import annotations

import torch


def coreness(indptr: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """[n] int32 coreness of the simple undirected graph in CSR form
    (``indptr`` [n+1] int64, ``indices`` [2m], both directions stored)."""
    device = indptr.device
    degree = indptr[1:] - indptr[:-1]
    n = degree.shape[0]
    remaining_degree = degree.clone()
    core = torch.zeros(n, dtype=torch.int32, device=device)
    alive = torch.nonzero(degree > 0).flatten()
    k = 0
    while alive.numel():
        d = remaining_degree[alive]
        peel = d <= k
        frontier = alive[peel]
        if frontier.numel() == 0:
            k = int(d.min())
            continue
        core[frontier] = k
        alive = alive[~peel]
        if not alive.numel():
            break
        # The frontier's neighbour slots, then one decrement per slot.
        lens = degree[frontier]
        slot_base = indptr[frontier] - (torch.cumsum(lens, 0) - lens)
        owner = torch.repeat_interleave(torch.arange(frontier.numel(), device=device), lens)
        slots = slot_base[owner] + torch.arange(owner.numel(), device=device)
        neighbours = indices[slots].to(torch.int64)
        remaining_degree.index_add_(
            0, neighbours, torch.full_like(neighbours, -1))
    return core
