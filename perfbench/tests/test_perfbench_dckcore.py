"""The dckcore runner: the conquer of the parts that ``dc_kcore`` built.

Every run here is on the CPU, on the ``gap-kron-s22-dc2`` configuration cut
to scale 11, with its threshold taken from that graph's coreness so that
both Exact-Divide parts hold nodes and rows of the second part carry
``ext`` > 0. Coreness does not depend on the labels, so one threshold holds
for every seed.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from perfbench import graph, harness, reference, spec
from perfbench.runners import dckcore

SEED = 2**31 + 11
CELL = "kron-s22-dc2-conquer"


@functools.lru_cache(maxsize=None)
def _max_core() -> int:
    cfg = spec.load_config("gap-kron-s22-dc2")
    cfg["scale"] = 11
    csr = graph.make_csr(cfg, SEED, "cpu")
    return int(reference.coreness(csr.indptr, csr.indices).max())


def small(threshold=None) -> dict:
    cfg = spec.load_config("gap-kron-s22-dc2")
    cfg["scale"] = 11
    cfg["divide"] = dict(cfg["divide"], thresholds=[
        _max_core() // 2 if threshold is None else threshold])
    return cfg


def run(config=None, entry=None, trace=False):
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, CELL)
    kind = "per_layer" if trace else "end_to_end"
    metrics = spec.cell_metrics(bench, cell, kind)
    return harness.run(config or small(), spec.load_traffic(cell["traffic"]),
                       seed=SEED, seconds=0.05, trace=trace, metrics=metrics,
                       readers=spec.load_readers(metrics), device="cpu", entry=entry)


@functools.lru_cache(maxsize=None)
def _part():
    return dckcore.Part(small(), spec.load_traffic("dc-conquer"), SEED, "cpu")


def test_two_parts_with_external_information():
    part = _part()
    top, rest = part.parts
    assert part.facts["parts"] == 2 and top.n_nodes > 0 and rest.n_nodes > 0
    assert top.n_nodes + rest.n_nodes == 1 << 11
    assert not top.ext.any() and rest.ext.any()
    assert part.facts["dckcore_preprocess_s"] > 0
    assert part.facts["part_nodes"] == [top.n_nodes, rest.n_nodes]
    assert part.facts["part_est_dtypes"] == ["int16", "int16"]
    assert part.facts["sweep_least_bytes"] > 0


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_window_answers_equal_the_reference(trace):
    result = run(trace=trace)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["checks"] == {"mismatched_nodes": {"value": 0, "limit": 0},
                                "unanswered": {"value": 0, "limit": 0}}
    if trace:
        assert result["metrics"]["dckcore.preprocess_s"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"coreness_s", "setup_s"}


def test_parts_scattered_back_equal_dc_kcore_merged():
    """The concatenated answer, scattered back by the reference's layout of
    the parts, is ``dc_kcore``'s own merged coreness, and the reference's."""
    from repro_torch.core import dc_kcore
    from repro_torch.graph import Graph

    cfg = small()
    csr = graph.make_csr(cfg, SEED, "cpu")
    core = reference.coreness(csr.indptr, csr.indices)
    indptr, indices = graph.to_host(csr)
    merged, _ = dc_kcore(Graph(indptr=indptr, indices=indices, n_nodes=csr.n_nodes),
                         cfg["divide"]["thresholds"], strategy="exact", engine="fused",
                         int16=True, device="cpu")
    t = cfg["divide"]["thresholds"][0]
    order = torch.argsort((core < t).to(torch.int8), stable=True).numpy()
    np.testing.assert_array_equal(dckcore.part_layout(core, [t]).numpy(),
                                  core.numpy()[order])
    scattered = np.empty_like(merged)
    scattered[order] = _part().call().coreness
    np.testing.assert_array_equal(scattered, merged)
    np.testing.assert_array_equal(scattered, core.numpy())


def test_result_sums_the_parts_decompositions():
    part = _part()
    got = part.call()
    each = [dckcore.port_entry()(bg, **part.kwargs) for bg in part.parts]
    np.testing.assert_array_equal(got.coreness, np.concatenate([r.coreness for r in each]))
    assert got.iterations == sum(r.iterations for r in each)
    assert got.gathered_rows == sum(r.gathered_rows for r in each)
    assert got.full_sweep_rows == sum(r.full_sweep_rows for r in each)
    assert got.part_iterations == [r.iterations for r in each]
    assert got.est_dtypes == [r.est_dtype for r in each]


class OnePartAltered:
    """The port, with one node's coreness raised by one in the answer of
    part ``index`` of every conquer (set-up's included: a raised answer of
    the top part stays at or above its threshold, so the parts are the
    same)."""

    def __init__(self, index: int):
        self.index, self.calls = index, 0

    def __call__(self, bg, **kw):
        r = dckcore.port_entry()(bg, **kw)
        self.calls += 1
        if (self.calls - 1) % 2 != self.index:
            return r
        c = r.coreness.copy()
        c[int(np.argmax(c))] += 1
        return dataclasses.replace(r, coreness=c)


@pytest.mark.parametrize("index", [0, 1], ids=["top", "rest"])
def test_one_part_altered_is_not_correct(index):
    result = run(entry=OnePartAltered(index))
    assert not result["correct"]
    assert result["checks"]["mismatched_nodes"]["value"] == 1
    assert result["checks"]["unanswered"]["value"] == 0
    assert result["failed"] == result["attempted"]


def test_threshold_above_the_largest_coreness_answers_with_one_part():
    cfg = small(threshold=_max_core() + 1)
    part = dckcore.Part(cfg, spec.load_traffic("dc-conquer"), SEED, "cpu")
    assert part.facts["parts"] == 1 and part.parts[0].n_nodes == 1 << 11
    assert not part.parts[0].ext.any()
    result = run(config=cfg)
    assert result["correct"] and result["failed"] == 0


def test_divide_runs_on_the_device_and_counts_its_slots():
    """Set-up divides on the run's device (here the CPU's): each part's
    divide passes count their slots and hold no host scratch."""
    from repro_torch.core import dc_kcore
    from repro_torch.graph import Graph

    cfg = small()
    csr = graph.make_csr(cfg, SEED, "cpu")
    indptr, indices = graph.to_host(csr)
    g = Graph(indptr=indptr, indices=indices, n_nodes=csr.n_nodes)
    kw = dict(strategy="exact", engine="fused", int16=True, device="cpu")
    on_host, host = dc_kcore(g, cfg["divide"]["thresholds"], **kw)
    on_dev, dev = dc_kcore(g, cfg["divide"]["thresholds"], divide_device="cpu", **kw)
    np.testing.assert_array_equal(on_dev, on_host)
    assert [p.n_nodes for p in dev.parts] == _part().facts["part_nodes"]
    assert [p.divide_transient_bytes for p in dev.parts] == [0, 0]
    assert host.parts[0].divide_transient_bytes > 0


def test_traffic_with_keys_of_another_runner_is_refused():
    with pytest.raises(ValueError, match="not the dckcore runner's"):
        dckcore.validate({"runner": "dckcore", "start": "prior"})
    dckcore.validate(spec.load_traffic("dc-conquer"))
