"""The models' mesh paths on real values: four gloo ranks on a (2, 2) mesh
over ("data", "model") against the one-card path.

The dry-run traces these paths on meta tensors; here each rank runs them on
real CPU tensors, as DTensors laid out by the sharding policy
(``launch/dryrun.py::on_mesh``: the dry-run's own context), and holds the
results, gathered whole, against the plain path on the same parameters:

* the logits of a forward pass and of a prefill, with the prefill's caches
  (batch-sharded, written by each rank into its rows), at ``F32_TOL``;
* a decode step with the caches' slot dim sharded (``LONG_DECODE_RULES``:
  the sharded cache write and the flash-decode combine), its logits and
  caches at ``F32_TOL``;
* a decode step of one row (the batch not split over "data", as in
  long-context decode): the weights stay sharded over "data" (no weight is
  gathered) and the token lookup is vocab-parallel, its logits and caches
  at ``F32_TOL``;
* the loss and every parameter's gradient (vocab-parallel loss, head-
  parallel attention, the SSM scan and the experts on local shards, ZeRO
  gradient layouts), in float64 so that round-off stays far below the
  tolerance (in float32 a random router's near ties amplify it): the loss at
  ``F32_TOL``, each gradient at ``F32_TOL`` after both are divided by the
  plain gradient's largest magnitude;
* for grok-1, a whole train step in float64 (two microbatches, full remat,
  Adafactor over the reference's stacked leaves with its factors laid out
  like the gradient): the loss and gradient norm, each parameter's update
  and each optimizer state leaf at ``F32_TOL`` after scaling by the plain
  one's largest magnitude.

The plain path runs under ``active_mesh`` of the mesh's axis sizes without
a ``DeviceMesh``, so that MoE dispatches within the same data-parallel
groups; its tensors stay plain. The cases cover attention (GQA), the SSM
and expert-parallel MoE (jamba), sliding-window ring caches and tied
embeddings (gemma3), tensor-parallel experts with shared experts
(qwen2-moe with the experts left unsharded), the SSM alone with tied
embeddings (mamba2), dense GQA attention with qk-norm (qwen3), and
tensor-parallel experts trained with Adafactor (grok-1).
"""
import json

import pytest

_CHILD = r"""
import copy, dataclasses, json, os
import numpy as np
import torch
import torch.distributed as dist
from torch import nn

rank, world = int(os.environ["REPRO_RANK"]), int(os.environ["REPRO_WORLD"])
dist.init_process_group("gloo", init_method="file://{store}", rank=rank, world_size=world)
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import on_mesh
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import blocks, layers
from repro_torch.models.model import CausalLM, loss_fn
from repro_torch.models.module import init_params, param_shardings
from repro_torch.models.parity import F32_TOL
from repro_torch.sharding.policy import (DEFAULT_RULES, LONG_DECODE_RULES, Spec, active_mesh,
                                         placements, resolve)

arch, overrides = "{arch}", json.loads('{overrides}')
TRAIN_STEP = {train_step}
mesh = make_device_mesh((2, 2), ("data", "model"))
AXES = {"data": 2, "model": 2}
RULES = dict(DEFAULT_RULES, **overrides)
LONG = dict(LONG_DECODE_RULES, **overrides)
B, S = 4, 16
rng = np.random.default_rng(0)


def sharded(model, rules):
    out = copy.deepcopy(model)
    for key, spec in param_shardings(out, mesh, rules).items():
        owner, _, name = key.rpartition(".")
        mod = out.get_submodule(owner) if owner else out
        value = mod._parameters[name].detach()
        mod._parameters[name] = nn.Parameter(distribute_tensor(value, mesh, placements(spec, mesh)))
    return out


def whole(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().double().numpy()


def close(got, want, what, scale=1.0):
    np.testing.assert_allclose(whole(got) / scale, whole(want) / scale, err_msg=what, **F32_TOL)


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def cache_tree(caches, specs, rules):
    def place(c, sd):
        if isinstance(c, dict):
            return {k: place(c[k], sd[k]) for k in c}
        shape, axes, _dtype = sd
        return distribute_tensor(c.clone(), mesh, placements(resolve(shape, axes, mesh, rules), mesh))
    return [place(c, sd) for c, sd in zip(caches, specs)]


def batch_dt(t):
    return distribute_tensor(t, mesh, placements(Spec("data", *(None,) * (t.ndim - 1)), mesh))


cfg = get_smoke_config(arch)
tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).long()
labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).long()
done = []

# --- float32: logits, prefill, slot-sharded decode ---------------------- #
model = init_params(CausalLM(cfg, device="cpu"), 0)
dm = sharded(model, RULES)
with torch.no_grad():
    with active_mesh(AXES, RULES):
        want, _, _ = model(tokens)
        want_last, want_caches = model.prefill(tokens[:, :S - 1], max_len=S)
    with on_mesh(mesh, RULES):
        got, _, _ = dm(batch_dt(tokens))
        got_last, got_caches = dm.prefill(batch_dt(tokens[:, :S - 1]), max_len=S)
    assert any(p.is_shard(2) for p in got.placements), got.placements  # vocab-parallel
    close(got, want, "logits")
    close(got_last, want_last, "prefill logits")
    for layer, (gc, wc) in enumerate(zip(got_caches, want_caches)):
        for path, w in leaves(wc):
            g = gc
            for k in path:
                g = g[k]
            close(g, w, f"prefill cache {layer} {path}")
    done += ["logits", "prefill"]

    specs = blocks.cache_specs_tree(cfg, B, S)
    dcaches = cache_tree(want_caches, specs, LONG)
    slot_sharded = [t for c in dcaches for path, t in leaves(c)
                    if path[-1] == "k" and any(p.is_shard(1) for p in t.placements)]
    dm_long = sharded(model, LONG)
    tok, pos = tokens[:, S - 1:], torch.full((B,), S - 1, dtype=torch.long)
    with active_mesh(AXES, LONG):
        want, want_caches = model.decode_step(want_caches, tok, pos)
    with on_mesh(mesh, LONG):
        got, got_caches = dm_long.decode_step(dcaches, tok, pos)
    close(got, want, "decode logits")
    for layer, (gc, wc) in enumerate(zip(got_caches, want_caches)):
        for path, w in leaves(wc):
            g = gc
            for k in path:
                g = g[k]
            close(g, w, f"decode cache {layer} {path}")
    done += ["decode"]

    # One row (long-context decode): the batch is not split over "data", so
    # the weights stay sharded there (no gather) and the token lookup is
    # vocab-parallel.
    with active_mesh(AXES, LONG):
        _, one_caches = model.prefill(tokens[:1, :S - 1], max_len=S)
    dcaches = cache_tree(one_caches, blocks.cache_specs_tree(cfg, 1, S), LONG)
    tok, pos = tokens[:1, S - 1:], torch.full((1,), S - 1, dtype=torch.long)
    with active_mesh(AXES, LONG):
        want, want_caches = model.decode_step(one_caches, tok, pos)
    gathers = []
    plain_gather = layers.fsdp_gather
    layers.fsdp_gather = lambda w: gathers.append(w.shape) or plain_gather(w)
    try:
        with on_mesh(mesh, LONG):
            got, got_caches = dm_long.decode_step(dcaches, tok, pos)
    finally:
        layers.fsdp_gather = plain_gather
    assert gathers == [], gathers
    close(got, want, "one-row decode logits")
    for layer, (gc, wc) in enumerate(zip(got_caches, want_caches)):
        for path, w in leaves(wc):
            g = gc
            for k in path:
                g = g[k]
            close(g, w, f"one-row decode cache {layer} {path}")
    done += ["one-row decode"]

# --- float64: loss and gradients --------------------------------------- #
cfg = dataclasses.replace(cfg, dtype=torch.float64, param_dtype=torch.float64)
model = init_params(CausalLM(cfg, device="cpu"), 0)
dm = sharded(model, RULES)
for p in list(model.parameters()) + list(dm.parameters()):
    p.requires_grad_(True)
with active_mesh(AXES, RULES):
    want, _ = loss_fn(model, {"tokens": tokens, "labels": labels})
want.backward()
with on_mesh(mesh, RULES):
    got, _ = loss_fn(dm, {"tokens": batch_dt(tokens), "labels": batch_dt(labels)})
    got.backward()
close(got, want, "loss")
n_grads = 0
for (key, p), (_, q) in zip(model.named_parameters(), dm.named_parameters()):
    scale = float(p.grad.abs().max()) or 1.0
    close(q.grad, p.grad, f"grad {key}", scale)
    n_grads += 1
done += ["loss", "grads"]

# --- float64: a whole train step (two microbatches, full remat, the
# configuration's optimizer) ------------------------------------------- #
if TRAIN_STEP:
    from repro_torch.launch.steps import step_fn_for
    from repro_torch.optim import get_optimizer

    fn, _order = step_fn_for(cfg, "train", lr=1e-2, accum_steps=2)
    model = init_params(CausalLM(cfg, device="cpu"), 1)
    dm = sharded(model, RULES)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = get_optimizer(cfg, lr=1e-2).init(dict(before))
    dstate = {}
    for path, t in leaves(state):
        node = dstate
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = distribute_tensor(t.clone(), mesh, placements(Spec(), mesh))
    batch = {"tokens": tokens, "labels": labels}
    with active_mesh(AXES, RULES):
        _, state, want = fn(model, state, torch.tensor(0), batch)
    with on_mesh(mesh, RULES):
        _, dstate, got = fn(dm, dstate, torch.tensor(0), {k: batch_dt(v) for k, v in batch.items()})
    close(got["loss"], want["loss"], "train loss")
    close(got["grad_norm"], want["grad_norm"], "train grad norm")
    for (key, p), (_, q) in zip(model.named_parameters(), dm.named_parameters()):
        step_want = p.detach() - before[key]
        scale = float(step_want.abs().max()) or 1.0
        close(q.full_tensor().detach() - before[key], step_want, f"update {key}", scale)
    for path, w in leaves(state):
        g = dstate
        for k in path:
            g = g[k]
        close(g, w, f"optimizer state {path}", float(w.abs().max()) or 1.0)
    done += ["train step"]
print("RESULT " + json.dumps(dict(done=done, slot_sharded=len(slot_sharded), n_grads=n_grads)))
dist.destroy_process_group()
"""


def _result(stdout):
    lines = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
    assert len(lines) == 1, stdout
    return json.loads(lines[0][len("RESULT "):])


@pytest.mark.parametrize("arch,overrides", [
    ("jamba-1.5-large-398b", {}),
    ("gemma3-27b", {}),
    ("qwen2-moe-a2.7b", {"experts": None}),
    ("mamba2-130m", {}),
    ("qwen3-8b", {}),
    # grok-1's layout: its experts do not divide the model axis, so
    # expert_mlp is sharded there; Adafactor over stacked leaves.
    ("grok-1-314b", {"experts": None}),
])
def test_mesh_matches_one_card(worker_harness, tmp_path, arch, overrides):
    train_step = arch == "grok-1-314b"
    code = (_CHILD.replace("{store}", str(tmp_path / "store")).replace("{arch}", arch)
            .replace("{overrides}", json.dumps(overrides))
            .replace("{train_step}", str(train_step)))
    for rank in range(4):
        worker_harness.spawn(code, n_devices=1, rank=rank, world=4,
                             extra_env={"OMP_NUM_THREADS": "2"})
    outs = [_result(o) for o in worker_harness.join(timeout=300)]
    assert all(o == outs[0] for o in outs), outs
    assert outs[0]["done"] == ["logits", "prefill", "decode", "one-row decode", "loss",
                               "grads"] + ["train step"] * train_step
    assert outs[0]["n_grads"] > 0
    # The attention caches are slot-sharded for the decode step (mamba2 has
    # none).
    assert (outs[0]["slot_sharded"] > 0) == (arch != "mamba2-130m")


@pytest.mark.parametrize("x", [-30.0, -1.0, 0.0, 19.5, 20.5, 60.0, 100.0, 1000.0])
def test_ssm_dt_softplus(x):
    """The SSM's written-out softplus (one code for one card and a mesh)
    equals ``F.softplus`` in value and gradient, finite where ``exp`` of the
    input would overflow float32 (x above about 88.7)."""
    import torch
    import torch.nn.functional as F
    from types import SimpleNamespace

    from repro_torch.models.ssm import _dt

    dtv = torch.full((1, 1, 3), x, dtype=torch.float32, requires_grad=True)
    got = _dt(SimpleNamespace(dt_bias=torch.zeros(3)), dtv)
    got.sum().backward()
    dtv2 = dtv.detach().clone().requires_grad_(True)
    want = F.softplus(dtv2)
    want.sum().backward()
    assert torch.isfinite(got).all() and torch.isfinite(dtv.grad).all()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dtv.grad, dtv2.grad, atol=1e-6, rtol=1e-6)
