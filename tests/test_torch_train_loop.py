"""The port's training loop (``repro_torch.runtime.TrainLoop``), its
checkpoints, ``launch/train.py`` and ``examples/torch/train_lm.py`` against
the JAX package's, on the CPU.

* A 5-step run against the JAX ``TrainLoop`` from the same parameters and
  data (granite-3-2b's smoke config with AdamW, grok-1's with Adafactor and
  bf16 parameters): every step's loss within rtol 1e-4, the parameters
  within a tolerance tied to the learning rate
  (``models/parity.py::train_param_agreement``, which states its
  derivation; ``chip_smoke.py`` holds the card to the CPU by it).
* Crash at step 8 after a step-5 checkpoint, resume to step 12: the
  parameters bit-identical to an uninterrupted run's (the reference's own
  property, ``tests/test_runtime.py::test_train_resume_bit_identical``).
* A checkpoint written by the JAX ``TrainLoop`` resumes in the port, and one
  written by the port in the JAX ``TrainLoop``: the same leaf files and
  shapes, the restored parameters and state bit-identical to the writer's.
* ``to_reference(from_reference(p)) == p`` for all ten published configs on
  meta tensors.
* ``python -m repro_torch.launch.train --smoke --device cpu`` prints the
  reference launcher's lines; without a GPU and ``--device`` it raises.
* The example's parameter-count line equals the reference example's, and
  both report that the loss decreased.
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import optim as ref_optim
from repro.data import SyntheticTokens as RefTokens
from repro.launch import train as ref_train_cli
from repro.models import model as ref_model
from repro.models import module as ref_module
from repro.runtime import TrainLoop as RefLoop
from repro_torch import configs as port_configs
from repro_torch import optim as port_optim
from repro_torch.data import SyntheticTokens
from repro_torch.launch import train as port_train_cli
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.models.parity import TRAIN_LOSS_RTOL, train_param_agreement
from repro_torch.runtime import FailureInjector, InjectedFailure, TrainLoop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_models import _DTYPES, port_model, ref_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["granite-3-2b", "grok-1-314b"]  # AdamW (f32), Adafactor (bf16 parameters)
SCHED = dict(lr=1e-3, warmup=2, total=5)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _ref_loop(arch, tree, **kw):
    cfg = ref_configs.get_smoke_config(arch)
    return RefLoop(cfg=cfg, params=jax.tree.map(jnp.asarray, tree),
                   optimizer=ref_optim.get_optimizer(cfg, **SCHED),
                   data=RefTokens(cfg.vocab_size, 16, 2, seed=1), **kw)


def _port_loop(arch, tree, **kw):
    cfg = port_configs.get_smoke_config(arch)
    return TrainLoop(cfg=cfg, model=port_model(cfg, tree),
                     optimizer=port_optim.get_optimizer(cfg, **SCHED),
                     data=SyntheticTokens(cfg.vocab_size, 16, 2, seed=1), **kw)


def _by_path(tree):
    return {jax.tree_util.keystr(path): leaf for path, leaf in _leaves(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_five_steps_match_the_reference_loop(arch):
    tree = ref_params(ref_configs.get_smoke_config(arch), 0, cross_gate=False)
    ref = _ref_loop(arch, tree)
    want = ref.run(5, log_every=1)
    port = _port_loop(arch, tree)
    got = port.run(5, log_every=1)
    assert got["step"] == want["step"] == [1, 2, 3, 4, 5]
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TRAIN_LOSS_RTOL)
    lr = port_optim.warmup_cosine(SCHED["lr"], SCHED["warmup"], SCHED["total"])
    train_param_agreement(_by_path(to_reference(port.cfg, port.model.state_dict())),
                          _by_path(jax.tree.map(np.asarray, ref.params)), lr, 5)


@pytest.mark.parametrize("arch", ARCHS)
def test_crash_and_resume_bit_identical(tmp_path, arch):
    tree = ref_params(ref_configs.get_smoke_config(arch), 0, cross_gate=False)
    a = _port_loop(arch, tree, ckpt_dir=str(tmp_path / "a"), ckpt_every=5, ckpt_blocking=True)
    a.run(12, log_every=1)
    b = _port_loop(arch, tree, ckpt_dir=str(tmp_path / "b"), ckpt_every=5, ckpt_blocking=True,
                   failure_injector=FailureInjector(fail_at={8}))
    with pytest.raises(InjectedFailure):
        b.run(12, log_every=1)
    c = _port_loop(arch, ref_params(ref_configs.get_smoke_config(arch), 1, cross_gate=False),
                   ckpt_dir=str(tmp_path / "b"), ckpt_every=5, ckpt_blocking=True)
    assert c.try_resume()
    assert c.step == 5
    c.run(12 - c.step, log_every=1)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, c.model.state_dict()[k]), k
    for (path, x), (_, y) in zip(_leaves(a.opt_state), _leaves(c.opt_state)):
        assert torch.equal(x, y), path


def _files(d):
    """(leaf file, shape, dtype) of every leaf of a checkpoint step dir."""
    import json

    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    return [(f, np.load(os.path.join(d, f)).shape, t) for f, t in zip(man["files"], man["dtypes"])]


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_resume_across_packages(tmp_path, arch):
    tree = ref_params(ref_configs.get_smoke_config(arch), 0, cross_gate=False)
    ref = _ref_loop(arch, tree, ckpt_dir=str(tmp_path / "ref"), ckpt_every=3, ckpt_blocking=True)
    ref.run(3, log_every=1)
    port = _port_loop(arch, tree, ckpt_dir=str(tmp_path / "port"), ckpt_every=3,
                      ckpt_blocking=True)
    port.run(3, log_every=1)
    assert _files(tmp_path / "ref" / "step_00000003") == _files(tmp_path / "port" / "step_00000003")

    # The JAX package's checkpoint, resumed by the port.
    into_port = _port_loop(arch, ref_params(ref_configs.get_smoke_config(arch), 1),
                           ckpt_dir=str(tmp_path / "ref"))
    assert into_port.try_resume() and into_port.step == 3
    want = jax.tree.map(np.asarray, {"params": ref.params, "opt": ref.opt_state})
    got = into_port._tree()
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        np.testing.assert_array_equal(_np32(g), _np32(w), err_msg=jax.tree_util.keystr(path))

    # The port's checkpoint, resumed by the JAX package.
    into_ref = _ref_loop(arch, ref_params(ref_configs.get_smoke_config(arch), 1),
                         ckpt_dir=str(tmp_path / "port"))
    assert into_ref.try_resume() and into_ref.step == 3
    want = port._tree()
    got = jax.tree.map(np.asarray, {"params": into_ref.params, "opt": into_ref.opt_state})
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        assert np.dtype(g.dtype).name == str(getattr(w, "dtype", "")).split(".")[-1]
        np.testing.assert_array_equal(_np32(g), _np32(w), err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_to_reference_inverts_from_reference(arch):
    """Every published config, on meta tensors: the reference's spec tree
    carried to the port and back has the same paths, shapes and dtypes."""
    ref_cfg = ref_configs.get_config(arch)
    cfg = port_configs.get_config(arch)
    meta = jax.tree.map(lambda s: torch.empty(s.shape, dtype=_DTYPES[s.dtype], device="meta"),
                        ref_model.build_specs(ref_cfg), is_leaf=ref_module.is_spec)
    back = to_reference(cfg, from_reference(cfg, meta))
    assert jax.tree.structure(back) == jax.tree.structure(meta)
    for (path, a), (_, b) in zip(_leaves(back), _leaves(meta)):
        assert (a.shape, a.dtype, a.device.type) == (b.shape, b.dtype, "meta"), path


def test_to_reference_round_trips_values():
    """With values: a smoke tree carried across and back is equal leaf for
    leaf (bf16 leaves as bf16 tensors of the same bits)."""
    for arch in ("jamba-1.5-large-398b", "whisper-small"):
        tree = ref_params(ref_configs.get_smoke_config(arch), 0)
        back = to_reference(port_configs.get_smoke_config(arch),
                            from_reference(port_configs.get_smoke_config(arch), tree))
        for (path, a), (_, b) in zip(_leaves(back), _leaves(tree)):
            np.testing.assert_array_equal(_np32(a), _np32(b), err_msg=str(path))


def test_train_cli_on_cpu(capsys, monkeypatch):
    """The launcher with ``--smoke --device cpu`` prints the reference's
    parameter line and one line per logged step, then the device line."""
    argv = ["--arch", "granite-3-2b", "--smoke", "--steps", "4", "--seq", "16"]
    port_train_cli.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    ref_train_cli.main()
    ref_out = capsys.readouterr().out.splitlines()
    assert port_out[0] == ref_out[0]
    step_line = re.compile(r"^step +(\d+)  loss +[\d.]+ +\d+ tok/s$")
    assert [step_line.match(l).group(1) for l in port_out[1:5]] == \
        [step_line.match(l).group(1) for l in ref_out[1:5]] == ["1", "2", "3", "4"]
    assert re.match(r"^device: cpu; step median [\d.]+ ms over 4 logged interval\(s\); "
                    r"[\d.]+ tokens/s; peak bytes not measured$", port_out[5])
    assert len(port_out) == 6


def test_train_cli_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for a host without one")
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        port_train_cli.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])


def test_train_lm_example_matches_reference_shape_line(tmp_path):
    port = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", "torch", "train_lm.py"),
         "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(OMP_NUM_THREADS="2"), cwd=tmp_path)
    ref = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", "train_lm.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(JAX_PLATFORMS="cpu"), cwd=tmp_path)
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
    port_lines, ref_lines = port_out.splitlines(), ref_out.splitlines()
    assert port_lines[0] == ref_lines[0] == "granite-3-2b-reduced: 1.15M params"
    assert port_lines[-1] == ref_lines[-1] == "loss decreased — training path OK"
    assert len(port_lines) == len(ref_lines) == 12  # ten logged steps


def test_train_lm_example_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for a host without one")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", "train_lm.py")],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert "device 'cuda' requested" in proc.stderr
