"""Drive the conquer of ``repro_torch.core.dc_kcore``: a divided graph's parts.

Set-up makes the configuration's graph on the device from the seed, hands a
host copy of its CSR to the port's ``dc_kcore`` with the configuration's
``divide.thresholds`` and ``layout``, and frees the device first.
``dc_kcore`` runs Exact-Divide in the order of its own pipeline (no
reordering, no prefetch): it divides, shrinks and folds E(v) into the
remaining nodes on the device (``divide_device``), lays each part out on
the host (its ``preprocess_time_s``, kept as ``dckcore_preprocess_s``),
and conquers each part through a ``decompose_fn`` that keeps the part, in
its order, and decomposes it with the configuration's engine: that run
warms every shape of the window. Each call of the window then decomposes the kept
parts back to back, ``decompose(bg, **engine)`` a part, each from its
``deg + ext``: DC-kCore's conquer, the card's share of it. Nothing here
divides, shrinks or lays out a part by itself.

A call answers with the parts' coreness concatenated in that order. Only
Exact-Divide is run: its part at threshold ``t`` is exactly the nodes of
coreness at least ``t`` (below the thresholds above it), every one of them
final, and ``induced_subgraph`` keeps ids in ascending order. So the
reference's answer, laid out part by part (:func:`part_layout`), is the
answer node for node, without anything from the port.
"""
from __future__ import annotations

import inspect
from typing import Callable, Optional

import numpy as np
import torch

from perfbench import graph, reference, roofline

TRAFFIC_KEYS = {"runner", "what", "arrivals_per_s"}


def port_entry() -> Callable:
    from repro_torch.core import decompose

    return decompose


def validate(traffic: dict) -> None:
    """Raises ``ValueError`` where the traffic's keys are not this runner's."""
    unknown = sorted(set(traffic) - TRAFFIC_KEYS)
    if unknown:
        raise ValueError(f"keys {unknown} are not the dckcore runner's "
                         f"(it takes {sorted(TRAFFIC_KEYS)})")


def part_layout(core: torch.Tensor, thresholds) -> torch.Tensor:
    """``core`` in the order of Exact-Divide's parts at ``thresholds``: the
    ids of coreness at least the largest threshold, ascending, then those
    of coreness at least the next one, and so on, then every other id,
    ascending."""
    bounds = torch.tensor(sorted({int(t) for t in thresholds}),
                          dtype=core.dtype, device=core.device)
    # A node's part: the count of thresholds above its coreness.
    part = (core.unsqueeze(1) < bounds.unsqueeze(0)).sum(dim=1)
    return core[torch.argsort(part, stable=True)]


def reference_answer(config: dict, traffic: dict, seed: int, device) -> np.ndarray:
    """The reference's answer: the graph made anew from the seed, peeled
    by ``reference.coreness``, laid out as the parts are."""
    csr = graph.make_csr(config, seed, torch.device(device))
    core = reference.coreness(csr.indptr, csr.indices)
    del csr
    return part_layout(core, config["divide"]["thresholds"]).cpu().numpy()


class ConquerResult:
    """One conquer of every part: the fields of ``DecomposeResult`` that
    ``perfbench/metrics/`` read, summed over the parts, and the parts'
    coreness concatenated in ``dc_kcore``'s order."""

    def __init__(self, results):
        self.coreness = np.concatenate([np.asarray(r.coreness) for r in results])
        self.iterations = sum(r.iterations for r in results)
        self.gathered_rows = sum(r.gathered_rows for r in results)
        self.full_sweep_rows = sum(r.full_sweep_rows for r in results)
        self.part_iterations = [r.iterations for r in results]
        self.est_dtypes = [r.est_dtype for r in results]


class Part:
    """The parts that the port's ``dc_kcore`` built, and their conquer."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 entry: Optional[Callable] = None):
        from repro_torch.core import dc_kcore
        from repro_torch.graph import Graph

        validate(traffic)
        dev = torch.device(device)
        self.entry = entry or port_entry()
        self.kwargs = dict(config["engine"], device=dev)
        csr = graph.make_csr(config, seed, dev)
        n = csr.n_nodes
        indptr, indices = graph.to_host(csr)
        del csr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.parts = []
        warm = []

        def capture(bg, **kw):
            self.parts.append(bg)
            result = self.entry(bg, **self.kwargs, **kw)
            warm.append(result)
            return result

        # A port older than ``divide_device`` divides on the host.
        where = ({"divide_device": dev} if "divide_device"
                 in inspect.signature(dc_kcore).parameters else {})
        _, report = dc_kcore(Graph(indptr=indptr, indices=indices, n_nodes=n),
                             config["divide"]["thresholds"], strategy="exact",
                             decompose_fn=capture, **where, **config["layout"])
        del indptr, indices
        least = 0
        for bg in self.parts:
            start = bg.degrees.astype(np.int64) + bg.ext
            least += roofline.full_sweep_bytes(
                int(bg.degrees.sum(dtype=np.int64)), int((bg.degrees > 0).sum()),
                int(start.max(initial=0)))
        self.facts = {
            "dckcore_preprocess_s": report.preprocess_time_s,
            "parts": len(self.parts),
            "part_nodes": [bg.n_nodes for bg in self.parts],
            "part_tiles": [len(bg.buckets) for bg in self.parts],
            "part_est_dtypes": [r.est_dtype for r in warm],
            "sweep_least_bytes": least,
        }

    def call(self):
        return ConquerResult([self.entry(bg, **self.kwargs) for bg in self.parts])

    def sweep_once(self):
        """One full sweep of every part from its start state (for the
        roofline share)."""
        return [self.entry(bg, **self.kwargs, max_iter=1) for bg in self.parts]

    @staticmethod
    def answer(result) -> np.ndarray:
        return np.asarray(result.coreness)

    def describe(self, warm) -> str:
        f = self.facts
        parts = "; ".join(
            f"{nodes} nodes, {tiles} tiles, {bg.padded_slots} padded slots, "
            f"{sweeps} sweeps, {width}"
            for bg, nodes, tiles, sweeps, width in zip(
                self.parts, f["part_nodes"], f["part_tiles"], warm.part_iterations,
                warm.est_dtypes))
        return (f"dc_kcore preprocess {f['dckcore_preprocess_s']:.3f} s, "
                f"{f['parts']} part(s): {parts}")

    def close(self) -> None:
        self.parts = None
