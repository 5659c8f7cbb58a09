"""The port's k-core examples (``examples/torch/*.py``) against the JAX
package's (``examples/*.py``): each pair runs as two child interpreters side
by side, and every printed line that carries no seconds must be equal
(graph sizes, ``k_max``, ``comm``, ``peak``, the parts and the divide
tables). The reference's ``kcore_end_to_end`` keeps its snapshots under
``$TMPDIR``, so it gets a fresh one. The LM serving example
(``serve_lm.py``) draws its parameters from torch generators, so only its
generated-shape line is held to the reference's (on an architecture without
cross-attention: the reference's example passes no frames or vision
embeddings, where the port's draws them).
"""
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["quickstart", "multipart_divide", "kcore_end_to_end"]
ORACLE_LINE = {
    "quickstart": "all three methods consistent",
    "multipart_divide": "more parts -> less communication",
    "kcore_end_to_end": "CONSISTENT",
}
_SECONDS = re.compile(r"\b\d+\.\d+s\b")
_TABLE_ROW = re.compile(r"^\s*\d+\s+[\d,]+\s+\d+\.\d+\s+\d+\.\d+\s*$")  # parts comm preprocess_s peak


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _without_seconds(line: str) -> str:
    if _TABLE_ROW.match(line):
        fields = line.split()
        return " ".join(fields[:2] + fields[3:])
    return _SECONDS.sub("<s>", line)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_matches_reference(tmp_path, name):
    port = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", "torch", f"{name}.py"), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(TMPDIR=str(tmp_path)), cwd=tmp_path)
    ref = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", f"{name}.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(JAX_PLATFORMS="cpu", TMPDIR=str(tmp_path)), cwd=tmp_path)
    try:
        port_out, port_err = port.communicate(timeout=600)
        ref_out, ref_err = ref.communicate(timeout=600)
    finally:
        for p in (port, ref):
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert port.returncode == 0, port_err[-4000:]
    assert ref.returncode == 0, ref_err[-4000:]
    assert ORACLE_LINE[name] in port_out
    assert ([_without_seconds(l) for l in port_out.splitlines()]
            == [_without_seconds(l) for l in ref_out.splitlines()])
    # The port's snapshots live in a directory of their own, removed at the end.
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("dckcore_ckpt_")]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_never_falls_back_to_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for a host without one")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", f"{name}.py")],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert "device 'cuda' requested" in proc.stderr
    assert "graph:" not in proc.stdout  # it stopped before any work


def _serve_shape_line(out: str) -> str:
    line = next(l for l in out.splitlines() if "-reduced: " in l)
    return line.split(" tokens in ")[0]


def test_serve_lm_example_prints_the_reference_shape_line(tmp_path):
    args = ["--arch", "mamba2-130m", "--batch", "2", "--new-tokens", "6"]
    port = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", "serve_lm.py"), *args,
         "--device", "cpu"], capture_output=True, text=True, env=_env(), cwd=tmp_path,
        timeout=300)
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "serve_lm.py"), *args],
        capture_output=True, text=True, env=_env(JAX_PLATFORMS="cpu"), cwd=tmp_path,
        timeout=300)
    assert port.returncode == 0, port.stderr[-4000:]
    assert ref.returncode == 0, ref.stderr[-4000:]
    assert (_serve_shape_line(port.stdout) == _serve_shape_line(ref.stdout)
            == "mamba2-130m-reduced: 2x6")


def test_serve_lm_example_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for a host without one")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", "serve_lm.py")],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert "device 'cuda' requested" in proc.stderr
    assert "-reduced:" not in proc.stdout
