"""The port's LM serving path (``repro_torch.runtime.serve_loop``,
``repro_torch.launch.serve``) against the JAX package's, on the CPU.

* ``greedy_generate`` for every architecture at ``smoke_config()``, with the
  reference's parameters carried across (cross gates nonzero): the tokens
  must equal the reference's wherever the reference's top-two margin at that
  step exceeds 1e-3 (a nearer tie may break either way under round-off).
* Greedy tokens against teacher-forced argmax through the port's forward.
* ``python -m repro_torch.launch.serve``: with ``--device cpu --smoke`` it
  prints the reference launcher's shape line; without a GPU, the default
  ``--device cuda`` fails before any work, as ``CausalLM(cfg)`` does.

The greedy rule is ``repro_torch.models.parity.greedy_agreement``, which
``chip_smoke.py`` applies to the card against the CPU.
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
from repro.models import model as ref_model
from repro.runtime import greedy_generate as ref_greedy_generate
from repro_torch import configs as port_configs
from repro_torch.launch import serve as port_serve
from repro_torch.models import CausalLM, init_params
from repro_torch.models.parity import GREEDY_MARGIN, greedy_agreement
from repro_torch.runtime import greedy_generate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_models import extras_np, port_model, ref_params, to_jax, to_torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_greedy_generate_matches_reference(arch):
    ref_cfg = ref_configs.get_smoke_config(arch)
    cfg = port_configs.get_smoke_config(arch)
    tree = ref_params(ref_cfg, 3)
    params = jax.tree.map(jnp.asarray, tree)
    b, s, n_new = 2, 10, 8
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (b, s))
    ex = extras_np(cfg, b)
    want = np.asarray(ref_greedy_generate(params, jnp.asarray(prompt, jnp.int32), ref_cfg,
                                          n_new, extras=to_jax(ex, ref_cfg)))
    got = greedy_generate(port_model(cfg, tree), torch.from_numpy(prompt), n_new,
                          extras=to_torch(ex, cfg)).numpy()
    assert got.shape == want.shape == (b, n_new)
    fwd = jax.jit(ref_model.forward, static_argnums=2)

    def logits_at(row, t):
        seq = np.concatenate([prompt[row], want[row, :t]])[None]
        row_ex = None if ex is None else {k: v[row:row + 1] for k, v in ex.items()}
        return fwd(params, jnp.asarray(seq, jnp.int32), ref_cfg, to_jax(row_ex, ref_cfg))[0][0, -1]

    greedy_agreement(got, want, logits_at, cfg.vocab_size)


def test_greedy_agreement_rule():
    """Tokens may first differ only where the reference's top-two margin is
    at most ``GREEDY_MARGIN``."""
    want = np.array([[5, 6, 7], [1, 2, 3]])
    tie = np.array([0.0, 1.0, 1.0 - GREEDY_MARGIN / 2])
    clear = np.array([0.0, 1.0, 0.5])
    assert greedy_agreement(want.copy(), want, None, 3) == "equal"
    got = np.array([[5, 6, 7], [1, 9, 8]])
    seen = []
    note = greedy_agreement(got, want, lambda row, t: seen.append((row, t)) or tie, 3)
    assert seen == [(1, 1)] and note.startswith("row 1 differs from step 1")
    with pytest.raises(AssertionError, match="row 1 step 1"):
        greedy_agreement(got, want, lambda row, t: clear, 3)


def test_greedy_matches_teacher_forcing():
    """The port's greedy tokens equal the argmax of its own full forward over
    the growing sequence (the reference's
    ``test_greedy_generation_matches_teacher_forcing``)."""
    cfg = port_configs.get_smoke_config("qwen3-8b")
    model = init_params(CausalLM(cfg, device="cpu"), 3)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10)))
    n_new = 6
    stats = {}
    out = greedy_generate(model, prompt, n_new, stats=stats)
    assert stats["all_finite"] and len(stats["decode_s"]) == n_new - 1
    assert stats["prefill_s"] > 0
    seq = prompt
    for t in range(n_new):
        logits, _, _ = model(seq)
        nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)
        np.testing.assert_array_equal(out[:, t].numpy(), nxt.numpy())
        seq = torch.cat([seq, nxt[:, None]], dim=1)


def test_params_and_inputs_are_seeded():
    cfg = port_configs.get_smoke_config("llama-3.2-vision-11b")
    cpu = torch.device("cpu")
    a, b, c = (init_params(CausalLM(cfg, device=cpu), seed) for seed in (0, 0, 1))
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
    assert not torch.equal(a.layers[0].attn.wq, c.layers[0].attn.wq)
    prompt, extras = port_serve.random_inputs(cfg, 3, 7, 0, cpu)
    assert prompt.shape == (3, 7) and int(prompt.max()) < cfg.vocab_size
    assert extras["vision_embeds"].shape == (3, cfg.n_vision_tokens, cfg.d_model)
    again, _ = port_serve.random_inputs(cfg, 3, 7, 0, cpu)
    assert torch.equal(prompt, again)


def _shape_line(out: str, name: str) -> str:
    line = next(l for l in out.splitlines() if l.startswith(f"{name}: generated"))
    return re.sub(r" in \d+\.\d+s \(\d+\.\d+ tok/s\)$", "", line)


def test_launch_serve_cpu_matches_reference_shape_line():
    args = ["--arch", "whisper-small", "--smoke", "--batch", "3", "--prompt-len", "12",
            "--new-tokens", "5"]
    port = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args,
                           "--device", "cpu"], capture_output=True, text=True,
                          env=_env(), cwd=REPO, timeout=300)
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve", *args],
                         capture_output=True, text=True, env=_env(JAX_PLATFORMS="cpu"),
                         cwd=REPO, timeout=300)
    assert port.returncode == 0, port.stderr[-4000:]
    assert ref.returncode == 0, ref.stderr[-4000:]
    assert (_shape_line(port.stdout, "whisper-small") == _shape_line(ref.stdout, "whisper-small")
            == "whisper-small: generated (3, 5)")
    assert re.search(r"^device: cpu; prefill \d+\.\d+ ms; decode median \d+\.\d+ ms/token over "
                     r"4 steps; peak bytes not measured$", port.stdout, re.M), port.stdout


def test_launch_serve_in_process(capsys):
    port_serve.main(["--arch", "mamba2-130m", "--smoke", "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert _shape_line(out, "mamba2-130m") == "mamba2-130m: generated (2, 3)"


def test_causal_lm_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for a host without one")
    cfg = port_configs.get_smoke_config("qwen3-8b")
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        CausalLM(cfg)
    assert CausalLM(cfg, device="meta").embed.tokens.is_meta


def test_launch_serve_never_falls_back_to_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for a host without one")
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        port_serve.main(["--arch", "qwen3-8b", "--smoke"])
    assert "generated" not in capsys.readouterr().out
