"""``correct`` holds for the port and fails for the control and each fault.

Every run here drives ``harness.run`` as ``run.py`` does, past the look
for a GPU, on the CPU at scale 10 (the port's plain PyTorch versions of
its kernels), with the timed path broken underneath where a test says so.
Besides the committed traffic, a deletes mix (start from the prior
coreness after deleting edges) is run as data alone, as a later cell
would add it.
"""
import dataclasses

import numpy as np
import pytest

from perfbench import control, harness, spec
from perfbench.runners import decompose as decompose_runner

SEED = 2**31 + 11


def small(config: str) -> dict:
    cfg = spec.load_config(config)
    cfg["scale"] = 10
    return cfg


DELETES = {"runner": "decompose", "start": "prior", "delete_edges": 64}


def run(config, entry=None, trace=False, traffic=None):
    bench = spec.load_benchmark()
    cell = next(c for c in bench["workloads"] if c["config"] == config)
    kind = "per_layer" if trace else "end_to_end"
    metrics = spec.cell_metrics(bench, cell, kind)
    readers = spec.load_readers(metrics)
    traffic = traffic or spec.load_traffic(cell["traffic"])
    return harness.run(small(config), traffic, seed=SEED, seconds=0.05,
                       trace=trace, metrics=metrics, readers=readers,
                       device="cpu", entry=entry)


def port(bg, **kw):
    return decompose_runner.port_entry()(bg, **kw)


def with_coreness(result, coreness):
    return dataclasses.replace(result, coreness=coreness)


def unchanged_state(bg, **kw):
    """A decomposition that returns its start state: no sweep at all."""
    return port(bg, **kw, max_iter=0)


def half_left_out(bg, **kw):
    """Half of the nodes' answers left at their start state."""
    r = port(bg, **kw)
    start = port(bg, **kw, max_iter=0).coreness
    c = r.coreness.copy()
    c[len(c) // 2:] = start[len(c) // 2:]
    return with_coreness(r, c)


def one_answer_altered(bg, **kw):
    """One node's coreness raised by one where it is produced."""
    r = port(bg, **kw)
    c = r.coreness.copy()
    c[int(np.argmax(c))] += 1
    return with_coreness(r, c)


class RaisesInWindow:
    """Sound in set-up's warm decomposition, then every call raises: an
    answer that never comes."""

    def __init__(self):
        self.calls = 0

    def __call__(self, bg, **kw):
        self.calls += 1
        if self.calls > 1:
            raise RuntimeError("planted fault")
        return port(bg, **kw)


CONFIGS = ["gap-kron-s24", "gap-urand-s24"]
END_TO_END = {"coreness_s", "setup_s"}  # peak_device_gb: none on the CPU


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("traffic", [None, DELETES], ids=["conquer", "deletes"])
def test_port_is_correct(config, traffic):
    result = run(config, traffic=traffic)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == END_TO_END
    assert list(result)[-1] == "checks"
    assert result["checks"] == {"mismatched_nodes": {"value": 0, "limit": 0},
                                "unanswered": {"value": 0, "limit": 0}}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fault, check", [
    (unchanged_state, "mismatched_nodes"),
    (half_left_out, "mismatched_nodes"),
    (one_answer_altered, "mismatched_nodes"),
    (RaisesInWindow, "unanswered"),
])
def test_each_fault_is_not_correct(config, fault, check):
    result = run(config, entry=fault() if isinstance(fault, type) else fault)
    assert not result["correct"]
    assert result["checks"][check]["value"] > result["checks"][check]["limit"]
    assert result["failed"] == result["attempted"]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("traffic", [None, DELETES], ids=["conquer", "deletes"])
def test_unchanged_state_is_not_correct_from_either_start(config, traffic):
    result = run(config, entry=unchanged_state, traffic=traffic)
    assert not result["correct"]
    assert result["checks"]["mismatched_nodes"]["value"] > 0


@pytest.mark.parametrize("config", CONFIGS)
def test_control_is_not_correct(config):
    """The control: the port stopped one changing sweep short of its fixed
    point, through the harness's own comparison."""
    result = run(config, entry=control.stopped_short(decompose_runner.port_entry()))
    assert not result["correct"]
    assert result["checks"]["mismatched_nodes"]["value"] >= 1
    assert result["checks"]["unanswered"]["value"] == 0


def test_deletes_start_from_a_stale_upper_bound():
    """The deletes mix's start state is an upper bound of the answer that
    the deletion made stale, and its seed nodes are the deleted edges'
    endpoints."""
    config = small("gap-kron-s24")
    part = decompose_runner.Part(config, DELETES, SEED, "cpu")
    want = decompose_runner.reference_answer(config, DELETES, SEED, "cpu")
    start = part.kwargs["init_coreness"]
    assert np.all(start >= want) and np.any(start > want)
    assert 0 < part.kwargs["seed_nodes"].size <= 2 * DELETES["delete_edges"]


@pytest.mark.parametrize("config", CONFIGS)
def test_traced_run_on_the_cpu_reports_what_it_can_read(config):
    """Without a GPU the trace holds no device time: the device metrics are
    left out, never reported as 0; the counters are read."""
    result = run(config, trace=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert metrics["sweep.count"]["value"] >= 1
    assert 0 < metrics["frontier.rows_share"]["value"] <= 100
    assert metrics["layout.s"]["value"] > 0
    for name in ("upload.ms", "kernels.ms", "sweep_roofline", "device.idle_share"):
        assert name not in metrics
    assert result["device"]["busy_s"] == 0.0
    assert result["device"]["window_s"] > 0
