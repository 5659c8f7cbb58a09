"""BENCHMARK.json, the files it names, and run.py's failure paths."""
import json
import os
import re
import subprocess
import sys

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_cell_finds_its_files_by_name(bench):
    for cell in bench["workloads"]:
        assert spec.find_cell(bench, cell["name"]) is cell
        config = spec.load_config(cell["config"])
        spec.load_generator(config["generator"])
        traffic = spec.load_traffic(cell["traffic"])
        spec.load_runner(traffic["runner"])
        end_to_end = spec.cell_metrics(bench, cell, "end_to_end")
        assert "setup_s" in [m["name"] for m in end_to_end] and len(end_to_end) >= 2
        for kind in ("end_to_end", "per_layer"):
            readers = spec.load_readers(spec.cell_metrics(bench, cell, kind))
            assert readers and all(callable(r.read) for r in readers.values())


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert spec.load_config(c["name"])["reduced"] == c["reduced"]
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["config"] in configs and cell["chips"] == 1
        assert len(cell["why"]) <= 200
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


@pytest.mark.parametrize("lookup, name", [
    (spec.load_config, "no-such-config"),
    (spec.load_traffic, "no-such-traffic"),
    (spec.load_metric, "no.such.metric"),
    (spec.load_generator, "no_such_generator"),
    (spec.load_runner, "no_such_runner"),
])
def test_unknown_names_are_named(lookup, name):
    with pytest.raises(spec.SpecError, match=re.escape(repr(name))):
        lookup(name)


@pytest.mark.parametrize("name", ["../BENCHMARK", "a/b", ".hidden", ""])
def test_names_never_become_paths(name):
    with pytest.raises(spec.SpecError):
        spec.load_config(name)


def test_unknown_workload_is_named(bench):
    with pytest.raises(spec.SpecError, match="no workload named 'nope'"):
        spec.find_cell(bench, "nope")


def _run(*args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), *args],
                          cwd=spec.ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def test_run_without_a_gpu_fails_with_a_reason():
    out = _run("--workload", "kron-s24-conquer", "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_run_names_an_unknown_workload():
    out = _run("--workload", "nope", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode == 2 and out.stdout == ""
    assert "no workload named 'nope'" in out.stderr


def test_cell_metrics_honours_workloads():
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    assert [m["name"] for m in spec.cell_metrics(bench, {"name": "x"}, "per_layer")] == ["a", "b"]
    assert [m["name"] for m in spec.cell_metrics(bench, {"name": "y"}, "per_layer")] == ["a"]


def test_traffic_names_its_runner():
    traffic = spec.load_traffic("conquer")
    assert traffic["runner"] == "decompose" and traffic["start"] == "degree"
    assert "arrivals_per_s" not in traffic  # a closed loop
    json.dumps(traffic)


@pytest.mark.parametrize("traffic, reason", [
    ({"start": "degree"}, "names no runner"),
    ({"runner": "decompose", "start": "snapshot"}, "is not one of"),
    ({"runner": "decompose", "start": "prior"}, "delete_edges > 0"),
    ({"runner": "decompose", "start": "degree", "delete_edges": 8}, "delete_edges > 0"),
    ({"runner": "decompose", "arrivals_per_s": 0}, "not a positive number"),
])
def test_traffic_the_runner_cannot_run_is_refused(tmp_path, monkeypatch, traffic, reason):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "t.json").write_text(json.dumps(traffic))
    (tmp_path / "runners").symlink_to(spec.BENCH_DIR / "runners")
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    with pytest.raises(spec.SpecError, match=reason):
        spec.load_traffic("t")
