"""Drive ``repro_torch.core.decompose`` on one part: the conquer of DC-kCore.

Set-up makes the configuration's graph on the device from the seed,
applies the traffic's edits, hands a host copy of its CSR to the port's
``bucketize`` (timed as ``layout_s``) and frees the device. Each call of
the window is one decomposition of that part, ``decompose(bg, **engine)``,
from the traffic's start state:

* ``"start": "degree"``: ``deg + ext`` with ``ext`` = 0 (one part, the
  monolithic baseline);
* ``"start": "prior"``: ``delete_edges`` edges drawn from the seed are
  deleted in set-up, and every call starts from the exact coreness of the
  graph before the deletion, capped by the degree after it (an upper bound
  of the answer within the degree, the start that the port's serving path,
  ``core/incremental.py``, hands ``decompose``), with the deleted edges'
  endpoints as ``seed_nodes``: the serving path's resweep.

The traffic file sets these keys; nothing else here changes per cell.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from perfbench import graph, reference, roofline

START_STATES = ("degree", "prior")


def port_entry() -> Callable:
    from repro_torch.core import decompose

    return decompose


def _checked(traffic: dict) -> dict:
    start = traffic.get("start", "degree")
    if start not in START_STATES:
        raise ValueError(f"start {start!r} is not one of {START_STATES}")
    deletes = int(traffic.get("delete_edges", 0))
    if (start == "prior") != (deletes > 0):
        raise ValueError("start 'prior' goes with delete_edges > 0, and only it")
    return {"start": start, "delete_edges": deletes}


def validate(traffic: dict) -> None:
    """Raises ``ValueError`` where the traffic's keys are not this runner's."""
    _checked(traffic)


def _graph(config: dict, traffic: dict, seed: int, device):
    """The cell's graph after its edits, the start coreness (or ``None``)
    and the seed nodes (or ``None``), all on ``device``."""
    t = _checked(traffic)
    csr = graph.make_csr(config, seed, device)
    if t["start"] == "degree":
        return csr, None, None
    prior = reference.coreness(csr.indptr, csr.indices)
    csr, endpoints = graph.delete_edges(csr, t["delete_edges"], seed)
    prior = torch.minimum(prior, csr.degrees().to(prior.dtype))
    return csr, prior, endpoints


def reference_answer(config: dict, traffic: dict, seed: int, device) -> np.ndarray:
    """The reference's answer: the graph made anew from the seed, edited,
    and peeled by ``reference.coreness``."""
    csr, prior, endpoints = _graph(config, traffic, seed, torch.device(device))
    del prior, endpoints
    return reference.coreness(csr.indptr, csr.indices).cpu().numpy()


class Part:
    """The port's bucketed part of the cell's graph and the call on it."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 entry: Optional[Callable] = None):
        from repro_torch.graph import Graph, bucketize

        dev = torch.device(device)
        self.entry = entry or port_entry()
        csr, prior, endpoints = _graph(config, traffic, seed, dev)
        degree = csr.degrees()
        start_max = int(degree.max()) if prior is None else int(prior.max())
        least_bytes = roofline.full_sweep_bytes(
            csr.indices.numel(), int((degree > 0).sum()), start_max)
        n = csr.n_nodes
        indptr, indices = graph.to_host(csr)
        self.kwargs = dict(config["engine"], device=dev)
        if prior is not None:
            self.kwargs.update(init_coreness=prior.cpu().numpy(),
                               seed_nodes=endpoints.cpu().numpy())
        del csr, degree, prior, endpoints
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_layout = time.perf_counter()
        self.bg = bucketize(Graph(indptr=indptr, indices=indices, n_nodes=n),
                            **config["layout"])
        self.facts = {"layout_s": time.perf_counter() - t_layout,
                      "sweep_least_bytes": least_bytes}

    def call(self):
        return self.entry(self.bg, **self.kwargs)

    def sweep_once(self):
        """One full sweep from the start state (for the roofline share):
        every tile, whatever the seed nodes."""
        kwargs = {k: v for k, v in self.kwargs.items() if k != "seed_nodes"}
        return self.entry(self.bg, **kwargs, max_iter=1)

    @staticmethod
    def answer(result) -> np.ndarray:
        return np.asarray(result.coreness)

    def describe(self, warm) -> str:
        return (f"bucketize {self.facts['layout_s']:.3f} s, {len(self.bg.buckets)} "
                f"tiles, {self.bg.padded_slots} padded slots; warm decomposition "
                f"{warm.iterations} sweeps, {warm.est_dtype}, "
                f"{warm.fused_mode or 'unfused'}")

    def close(self) -> None:
        self.bg = None
