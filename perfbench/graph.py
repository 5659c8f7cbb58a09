"""Make a configuration's graph on the device: edges, labels, a simple CSR.

The edges are drawn from the configuration's fixed ``graph_seed``: like
the GAP suite's kron and urand, a configuration is one graph, so every
run does the same work. The run's ``--seed`` draws a random permutation
of the node labels (GAP's ``PermuteIDs``): the same graph in another
order, which moves the port's layout (which rows share a tile, the order
of the sweep) but not the work to be done.

The CSR is undirected and simple, as the GAP suite builds its graphs:
self-loops dropped, both directions of every edge stored once, each row's
neighbours ascending. It is the benchmark's own; the port receives a host
copy of it and the reference builds it anew from the seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import spec


@dataclasses.dataclass
class DeviceCSR:
    """``indptr`` [n+1] int64 and ``indices`` [2m] int32, on one device."""

    indptr: torch.Tensor
    indices: torch.Tensor
    n_nodes: int

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]


def simple_csr(src: torch.Tensor, dst: torch.Tensor, n: int) -> DeviceCSR:
    """Symmetrize, drop self-loops and duplicates, and sort (one
    ``torch.unique`` over ``u * n + v`` keys)."""
    return _csr_of([src, dst], n)


def _csr_of(edges: list, n: int) -> DeviceCSR:
    """:func:`simple_csr` of ``edges = [src, dst]``, which it empties, so
    that each array is freed as soon as it is used up."""
    src, dst = edges
    edges.clear()
    keep = src != dst
    src, dst = src[keep], dst[keep]
    keys = torch.cat([src * n + dst, dst * n + src])
    del src, dst, keep
    keys = torch.unique(keys, sorted=True)
    rows = torch.div(keys, n, rounding_mode="floor")
    indices = (keys - rows * n).to(torch.int32)
    del keys
    counts = torch.bincount(rows, minlength=n)
    del rows
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=indices.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return DeviceCSR(indptr=indptr, indices=indices, n_nodes=n)


def seeded_generator(seed: int, device: torch.device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed``; each ``stream`` draws apart."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + (int(stream) << 40)) % (1 << 64))
    return gen


def make_csr(config: dict, seed: int, device) -> DeviceCSR:
    """The configuration's graph with labels permuted by ``seed``, built on
    ``device``."""
    device = torch.device(device)
    make_edges = spec.load_generator(config["generator"]).edges
    scale, edge_factor = int(config["scale"]), int(config["edge_factor"])
    n = 1 << scale
    src, dst = make_edges(scale, edge_factor, config.get("params", {}),
                          seeded_generator(config["graph_seed"], device), device)
    label = torch.randperm(n, generator=seeded_generator(seed, device), device=device)
    edges = [label[src], label[dst]]
    del src, dst, label
    return _csr_of(edges, n)


def delete_edges(csr: DeviceCSR, count: int, seed: int):
    """``csr`` with ``count`` of its undirected edges deleted, drawn
    uniformly without replacement from ``seed``, and the deleted edges'
    endpoints (int64, on the CSR's device, ascending and distinct)."""
    device = csr.indptr.device
    n = csr.n_nodes
    rows = torch.repeat_interleave(torch.arange(n, device=device), csr.degrees())
    cols = csr.indices.to(torch.int64)
    upper = torch.nonzero(rows < cols).flatten()  # each edge once
    gen = seeded_generator(seed, device, stream=1)
    pick = upper[torch.randperm(upper.numel(), generator=gen, device=device)[:count]]
    del upper
    u, v = rows[pick], cols[pick]
    gone = torch.isin(rows * n + cols, torch.cat([u * n + v, v * n + u]))
    keep = ~gone
    del gone
    indices = csr.indices[keep]
    counts = torch.bincount(rows[keep], minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return DeviceCSR(indptr=indptr, indices=indices, n_nodes=n), torch.unique(torch.cat([u, v]))


def to_host(csr: DeviceCSR):
    """``(indptr, indices)`` numpy copies, the port's ``Graph`` dtypes."""
    return (csr.indptr.cpu().numpy().astype(np.int64, copy=False),
            csr.indices.cpu().numpy().astype(np.int32, copy=False))
