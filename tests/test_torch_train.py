"""The port's train step (``repro_torch.runtime.train_loop.make_train_step``,
``repro_torch.launch.steps``, remat in ``models/blocks.py``) against the JAX
package's, on the CPU.

* The gradients and loss of one train step for every architecture at
  ``smoke_config()``, with the reference's parameters carried across:
  both packages' ``make_train_step`` run with an optimizer that returns
  zero updates and keeps the gradients as its state (and no clipping), so
  the gradients are the step's own. Tolerance: ``models/parity.py``'s f32
  rule (atol 1e-4 and rtol 1e-4, or the reference's own movement when its
  f32 parameters move by one ulp, where that is larger); a bf16 leaf (the
  grok-1 and jamba parameters) also within one bf16 rounding (rtol 2^-7),
  since two f32 sums a round-off apart may round to neighbouring bf16
  values. granite-3-2b runs with ``remat`` none, full and dots; remat must
  not move the values (on the CPU they are bit-identical to none's).
* ``accum_steps=2``, in f32 and in bf16, against the reference's scan.
* ``step_fn_for``: the train kind remats; prefill and decode wrap the model.
* The step's deterministic mode is scoped to the step.
* On a GPU (marked ``cuda``, skipped here): one step on the card against the
  CPU, and two runs of the same step on the card bit-identical.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as port_configs
from repro_torch import optim as port_optim
from repro_torch.launch.steps import step_fn_for
from repro_torch.models import CausalLM, blocks, init_params
from repro_torch.models.convert import to_reference
from repro_torch.models.parity import F32_TOL, ulp_perturbed
from repro_torch.runtime import make_train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
try:
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro import optim as ref_optim
    from repro.runtime import train_loop as ref_train
    from test_torch_models import (extras_np, port_config, port_model, ref_params,
                                   to_jax, to_torch)
except ModuleNotFoundError:  # a GPU host without JAX runs this file's cuda test alone
    jax = None

B, S = 2, 12
BF16_ROUNDING = 2 ** -7
NO_CLIP = float("inf")


def _ref_capture():
    """An optimizer that changes nothing and keeps the gradients as its state."""
    return ref_optim.Optimizer(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p, step: (jax.tree.map(jnp.zeros_like, g), g))


def _port_capture():
    def update(grads, state, params, step):
        kept = {k: g.detach().clone() for k, g in grads.items()}
        return {k: torch.zeros_like(g) for k, g in grads.items()}, kept

    return port_optim.Optimizer(init=lambda p: {}, update=update)


def _batch(cfg, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (batch, S)),
            "labels": rng.integers(0, cfg.vocab_size, (batch, S)),
            "extras": extras_np(cfg, batch)}


def _jax_batch(b, ref_cfg):
    return {"tokens": jnp.asarray(b["tokens"], jnp.int32),
            "labels": jnp.asarray(b["labels"], jnp.int32), "extras": to_jax(b["extras"], ref_cfg)}


def _torch_batch(b, cfg):
    return {"tokens": torch.from_numpy(b["tokens"]), "labels": torch.from_numpy(b["labels"]),
            "extras": to_torch(b["extras"], cfg)}


def ref_step_grads(ref_cfg, trees, batch, **kw):
    """[(grads as numpy, metrics)] of the reference's train step, one per
    parameter tree (one compile)."""
    fn = jax.jit(ref_train.make_train_step(ref_cfg, _ref_capture(), max_grad_norm=NO_CLIP, **kw))
    out = []
    for tree in trees:
        params = jax.tree.map(jnp.asarray, tree)
        _, grads, metrics = fn(params, jax.tree.map(jnp.zeros_like, params), jnp.asarray(0),
                               _jax_batch(batch, ref_cfg))
        out.append((jax.tree.map(np.asarray, grads), {k: float(v) for k, v in metrics.items()}))
    return out


def assert_metrics_close(got, want, moved):
    """Loss, CE and grad norm by the f32 rule (``moved``: the reference's
    after a one-ulp change of its parameters)."""
    assert set(got) == set(want) == {"loss", "ce", "grad_norm"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=F32_TOL["rtol"],
                                   atol=max(F32_TOL["atol"], abs(moved[k] - want[k])), err_msg=k)


def port_step_grads(cfg, model, batch, **kw):
    """(grads in the reference's tree, metrics) of the port's train step."""
    fn = make_train_step(cfg, _port_capture(), max_grad_norm=NO_CLIP, **kw)
    _, grads, metrics = fn(model, {}, torch.tensor(0), _torch_batch(batch, cfg))
    return to_reference(cfg, grads), {k: float(v) for k, v in metrics.items()}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_grads_close(got, want, moved):
    """``got`` against ``want`` by the f32 rule, ``moved`` being the
    reference's gradients after a one-ulp change of its f32 parameters."""
    sens = max(float(np.abs(_np32(m) - _np32(w)).max())
               for (_, m), (_, w) in zip(_leaves(moved), _leaves(want)))
    atol = max(F32_TOL["atol"], sens)
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        bf16 = isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16
        assert np.shape(g) == np.shape(w), path
        np.testing.assert_allclose(
            _np32(g), _np32(w), atol=atol,
            rtol=F32_TOL["rtol"] + (BF16_ROUNDING if bf16 else 0.0),
            err_msg=jax.tree_util.keystr(path))


CASES = [(arch, "none") for arch in port_configs.ARCHS] + \
    [("granite-3-2b", "full"), ("granite-3-2b", "dots")]


@pytest.mark.parametrize("arch,remat", CASES)
def test_train_step_grads_match_reference(arch, remat):
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), remat=remat)
    cfg = port_config(ref_cfg)
    tree = ref_params(ref_cfg, 0)
    batch = _batch(cfg)
    (want, want_m), (moved, moved_m) = ref_step_grads(ref_cfg, [tree, ulp_perturbed(tree)], batch)
    model = port_model(cfg, tree)
    got, got_m = port_step_grads(cfg, model, batch)
    assert_metrics_close(got_m, want_m, moved_m)
    assert_grads_close(got, want, moved)
    assert all(not p.requires_grad and p.grad is None for p in model.parameters())
    if remat != "none":
        plain, _ = port_step_grads(dataclasses.replace(cfg, remat="none"), model, batch)
        for (path, a), (_, b) in zip(_leaves(got), _leaves(plain)):
            np.testing.assert_array_equal(_np32(a), _np32(b), err_msg=jax.tree_util.keystr(path))


def test_remat_checkpoints_each_scanned_group_and_never_serving(monkeypatch):
    """A training forward checkpoints each scanned group once and never the
    unrolled tail (gemma3's smoke config: one group of 6, a tail of 2;
    granite's: 3 groups of 1), with the selective policy under ``dots``; a
    prefill never remats."""
    calls = []
    real = blocks.checkpoint

    def counting(fn, *args, **kw):
        calls.append("dots" if "context_fn" in kw else "full")
        return real(fn, *args, **kw)

    monkeypatch.setattr(blocks, "checkpoint", counting)
    for arch, remat, groups in (("granite-3-2b", "full", 3), ("granite-3-2b", "dots", 3),
                                ("gemma3-27b", "full", 1)):
        cfg = dataclasses.replace(port_configs.get_smoke_config(arch), remat=remat)
        model = init_params(CausalLM(cfg, device="cpu"), 0)
        tokens = torch.randint(0, cfg.vocab_size, (B, S))
        calls.clear()
        for p in model.parameters():
            p.requires_grad_(True)
        model.prefill(tokens)
        assert calls == []
        model(tokens)[0].sum().backward()
        assert calls == [remat] * groups, arch


@pytest.mark.parametrize("arch,accum_dtype", [("granite-3-2b", "float32"),
                                              ("grok-1-314b", "bfloat16")])
def test_grad_accumulation_matches_reference(arch, accum_dtype):
    """Two microbatches of 2: granite sums in f32 (autograd's own
    accumulation), grok-1 in bf16 (a buffer beside its bf16 parameters'
    gradients, which the reference sums in bf16 too)."""
    ref_cfg = ref_configs.get_smoke_config(arch)
    cfg = port_configs.get_smoke_config(arch)
    tree = ref_params(ref_cfg, 0)
    batch = _batch(cfg, seed=3, batch=4)
    jdt, tdt = getattr(jnp, accum_dtype), getattr(torch, accum_dtype)
    (want, want_m), (moved, moved_m) = ref_step_grads(
        ref_cfg, [tree, ulp_perturbed(tree)], batch, accum_steps=2, accum_dtype=jdt)
    got, got_m = port_step_grads(cfg, port_model(cfg, tree), batch, accum_steps=2,
                                 accum_dtype=tdt)
    assert_metrics_close(got_m, want_m, moved_m)
    for (_, g) in _leaves(got):
        assert g.dtype in (np.float32, np.dtype("float32"))  # divided, then f32
    if accum_dtype == "float32":
        assert_grads_close(got, want, moved)
    else:
        # Two bf16 sums: each may round to a neighbouring value.
        sens = max(float(np.abs(_np32(m) - _np32(w)).max())
                   for (_, m), (_, w) in zip(_leaves(moved), _leaves(want)))
        for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
            np.testing.assert_allclose(_np32(g), _np32(w), atol=max(1e-4, sens),
                                       rtol=2 * BF16_ROUNDING, err_msg=jax.tree_util.keystr(path))


def test_step_fn_for():
    """``train`` forces full remat over a config's ``none`` and trains with
    the config's optimizer; ``prefill`` and ``decode`` are the model's."""
    cfg = port_configs.get_smoke_config("granite-3-2b")
    assert cfg.remat == "none"
    model = init_params(CausalLM(cfg, device="cpu"), 0)
    train_fn, names = step_fn_for(cfg, "train", lr=1e-3, grad_shardings={"ignored": None})
    assert names == ("model", "opt_state", "step", "batch")
    state = port_optim.get_optimizer(cfg, lr=1e-3).init(dict(model.named_parameters()))
    before = model.embed.tokens.detach().clone()
    seen = []
    real = blocks.checkpoint
    blocks.checkpoint = lambda *a, **kw: seen.append(1) or real(*a, **kw)
    try:
        _, state, metrics = train_fn(model, state, torch.tensor(0), _torch_batch(_batch(cfg), cfg))
    finally:
        blocks.checkpoint = real
    assert len(seen) == cfg.n_layers and model.cfg.remat == "none"
    assert torch.isfinite(metrics["loss"]) and not torch.equal(before, model.embed.tokens)
    assert float(state["m"]["embed.tokens"].abs().sum()) > 0
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    prefill_fn, names = step_fn_for(cfg, "prefill")
    assert names == ("model", "tokens", "extras")
    logits, caches = prefill_fn(model, tokens, None)
    want, want_caches = model.prefill(tokens)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    decode_fn, names = step_fn_for(cfg, "decode")
    assert names == ("model", "caches", "token", "position", "extras")
    pos = torch.full((B,), S)
    got, _ = decode_fn(model, caches, tokens[:, :1], pos, None)
    torch.testing.assert_close(got, model.decode_step(want_caches, tokens[:, :1], pos)[0],
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        step_fn_for(cfg, "bogus")


def test_deterministic_mode_is_scoped_to_the_step():
    cfg = port_configs.get_smoke_config("granite-3-2b")
    model = init_params(CausalLM(cfg, device="cpu"), 0)
    seen = []

    def update(grads, state, params, step):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return {k: torch.zeros_like(g) for k, g in grads.items()}, state

    opt = port_optim.Optimizer(init=lambda p: {}, update=update)
    assert not torch.are_deterministic_algorithms_enabled()
    batch = _torch_batch(_batch(cfg), cfg)
    make_train_step(cfg, opt)(model, {}, 0, batch)
    make_train_step(cfg, opt, deterministic=False)(model, {}, 0, batch)
    assert seen == [True, False]
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.cuda
def test_train_step_on_the_card():
    """One AdamW step of granite-3-2b's smoke config on the card against the
    CPU (TF32 off; loss within rtol 1e-5, parameters within the f32 rule),
    and the same step twice on the card: bit-identical parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = port_configs.get_smoke_config("granite-3-2b")
    ref = init_params(CausalLM(cfg, device="cpu"), 0)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
             for k in ("tokens", "labels")}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        results = []
        for device in ("cpu", "cuda", "cuda"):
            model = CausalLM(cfg, device=device)
            model.load_state_dict(ref.state_dict())
            opt = port_optim.get_optimizer(cfg, lr=1e-3, warmup=0)
            state = opt.init(dict(model.named_parameters()))
            dev_batch = {k: v.to(device) for k, v in batch.items()}
            _, _, m = make_train_step(cfg, opt)(model, state, torch.tensor(0, device=device),
                                                dev_batch)
            results.append((float(m["loss"]), {k: v.cpu() for k, v in model.state_dict().items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (l_cpu, p_cpu), (l_a, p_a), (l_b, p_b) = results
    assert l_a == l_b
    np.testing.assert_allclose(l_a, l_cpu, rtol=1e-5)
    for k in p_cpu:
        assert torch.equal(p_a[k], p_b[k]), k
        torch.testing.assert_close(p_a[k], p_cpu[k], **F32_TOL)
