"""The port's optimizers and token sources (``repro_torch.optim``,
``repro_torch.data``) against the JAX package's, on the CPU.

* ``warmup_cosine`` at every step from 0 to ``total``;
* AdamW and Adafactor: each ``update`` gets the same gradients, state,
  parameters and step in both packages, three updates in a row; the updates
  and the state agree within atol 1e-7 and rtol 1e-6 (f32 round-off: the
  two packages' ``pow``, ``sqrt`` and reduction orders differ in the last
  bit). Adafactor runs on a stacked tree with 1-D and 0-D-per-layer stacked
  leaves, which the port holds unstacked (one tensor per layer) and
  updates through the reference's leaves;
* ``global_norm`` and ``clip_by_global_norm`` (within rtol 1e-6);
* ``get_optimizer``'s state for a model: the reference's tree, leaf by leaf;
* ``SyntheticTokens``, ``MemmapTokens`` and ``Prefetcher`` bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import data as ref_data
from repro import optim as ref_optim
from repro.models import model as ref_model
from repro.models import module as ref_module
from repro_torch import configs as port_configs
from repro_torch import data as port_data
from repro_torch import optim as port_optim
from repro_torch.models import CausalLM
from repro_torch.models.convert import RefLeaf, reference_leaves


TOL = dict(atol=1e-7, rtol=1e-6)


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=msg, **tol)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# --------------------------------------------------------------------- #
# Schedule
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 100, 10_000), (1e-3, 20, 200),
                                               (3e-3, 0, 57), (1e-2, 5, 5)])
def test_warmup_cosine_matches_reference(peak, warmup, total):
    steps = np.arange(0, total + 2, dtype=np.float32)
    want = np.asarray(jax.vmap(ref_optim.warmup_cosine(peak, warmup, total))(jnp.asarray(steps)))
    lr = port_optim.warmup_cosine(peak, warmup, total)
    got = np.array([float(lr(torch.tensor(s))) for s in steps], np.float32)
    _close(got, want)
    assert lr(torch.tensor(3.0)).dtype == torch.float32
    assert float(lr(3)) == float(lr(torch.tensor(3.0)))  # a Python step too


# --------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------- #
def _grad_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((7, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(11) * scale).astype(np.float32),
                  "d": np.float32(rng.standard_normal() * scale)}}


def _torch_tree(tree):
    return jax.tree.map(_t, tree)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_global_norm_and_clip_match_reference(scale):
    tree = _grad_tree(3, scale)
    want_norm = ref_optim.global_norm(jax.tree.map(jnp.asarray, tree))
    _close(port_optim.global_norm(_torch_tree(tree)), want_norm, dict(atol=0, rtol=1e-6))
    want, want_n = ref_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    got, got_n = port_optim.clip_by_global_norm(_torch_tree(tree), 1.0)
    _close(got_n, want_n, dict(atol=0, rtol=1e-6))
    jax.tree.map(lambda g, w: _close(g, w, dict(atol=1e-7, rtol=1e-6)), got, want)
    assert (float(got_n) > 1.0) == (scale > 0.1)  # both sides of the clip run


def test_clip_bf16_leaf_and_in_place():
    """A bf16 leaf is scaled in its own dtype (the reference casts the scale
    to it), and the port scales the tensors it was given."""
    tree = _grad_tree(4, 5.0)
    tree["e"] = np.linspace(-3, 3, 9).astype(np.float32)
    want, _ = ref_optim.clip_by_global_norm(
        {**jax.tree.map(jnp.asarray, tree), "e": jnp.asarray(tree["e"], jnp.bfloat16)}, 2.0)
    port = {**_torch_tree(tree), "e": _t(tree["e"]).bfloat16()}
    a = port["a"]
    got, _ = port_optim.clip_by_global_norm(port, 2.0)
    assert got["a"] is a and got["e"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["e"].float().numpy(), np.asarray(want["e"], np.float32))
    _close(got["a"], want["a"])


# --------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------- #
def _adamw_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 4), "b": (4,), "s": (), "t": (2, 3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    m = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    v = {k: (rng.random(s) * 0.05).astype(np.float32) for k, s in shapes.items()}
    return params, grads, {"m": m, "v": v}


@pytest.mark.parametrize("step0", [0, 7, 150])
def test_adamw_update_matches_reference(step0):
    """Three updates in a row from a nonzero state: the updates, the state
    and the parameters they give, against the reference's."""
    params, grads, state = _adamw_inputs(step0)
    sched = (3e-3, 20, 200)
    ref = ref_optim.adamw(ref_optim.warmup_cosine(*sched))
    port = port_optim.adamw(port_optim.warmup_cosine(*sched))
    r_params, r_state = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)
    p_params, p_state = _torch_tree(params), _torch_tree(state)
    for i, g in enumerate(grads):
        step = step0 + i
        r_upd, r_state = ref.update(jax.tree.map(jnp.asarray, g), r_state, r_params,
                                    jnp.asarray(step))
        p_grads = _torch_tree(g)
        p_upd, p_state = port.update(p_grads, p_state, p_params, torch.tensor(step))
        for k in g:
            _close(p_upd[k], r_upd[k], msg=f"update {k} step {step}")
            _close(p_state["m"][k], r_state["m"][k], msg=f"m {k}")
            _close(p_state["v"][k], r_state["v"][k], msg=f"v {k}")
            assert p_upd[k] is p_grads[k]  # written into the f32 gradient's storage
        r_params = ref_optim.apply_updates(r_params, r_upd)
        port_optim.apply_updates(p_params, p_upd)
        for k in g:
            _close(p_params[k], r_params[k], msg=f"param {k}")


def test_adamw_init_is_f32_zeros():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16), "b": torch.ones(2)}
    state = port_optim.adamw(lambda s: s).init(params)
    want = ref_optim.adamw(lambda s: s).init({"w": jnp.ones((3, 2), jnp.bfloat16),
                                              "b": jnp.ones(2)})
    for part in ("m", "v"):
        for k in params:
            assert state[part][k].dtype == torch.float32
            assert tuple(state[part][k].shape) == want[part][k].shape
            assert not state[part][k].any()


# --------------------------------------------------------------------- #
# Adafactor on stacked leaves
# --------------------------------------------------------------------- #
# The reference's tree: a scan of three groups (leading axis 3) holding a
# [3, 64] norm scale (a 1-D parameter per layer, factored as a stacked
# leaf), a [3, 8, 16] matrix and a [3] scalar gate; a tail of unstacked
# leaves (a matrix, a vector, a scalar).
STACKED = {"scan": {"scale": (3, 64), "w": (3, 8, 16), "gate": (3,)},
           "tail": {"w": (8, 16), "b": (5,), "gate": ()}}


def _stacked_layout():
    leaves = []
    for top, sub in STACKED.items():
        for name, shape in sub.items():
            if top == "scan":
                keys = tuple(f"scan.{g}.{name}" for g in range(shape[0]))
                leaves.append(RefLeaf((top, name), keys, True))
            else:
                leaves.append(RefLeaf((top, name), (f"tail.{name}",), False))
    return sorted(leaves)


def _unstack(tree):
    flat = {}
    for top, sub in tree.items():
        for name, a in sub.items():
            if top == "scan":
                for g in range(a.shape[0]):
                    flat[f"scan.{g}.{name}"] = _t(a[g])
            else:
                flat[f"tail.{name}"] = _t(a)
    return flat


def _stacked_tree(rng, scale, dtype=np.float32):
    return {top: {name: (rng.standard_normal(shape) * scale).astype(dtype)
                  for name, shape in sub.items()} for top, sub in STACKED.items()}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("step0", [0, 40])
def test_adafactor_update_matches_reference_on_stacked_leaves(step0, weight_decay):
    """Factoring, the clipping RMS and the relative-step scale are taken
    over each whole stacked leaf: the [3, 64] scale is factored (vr [3],
    vc [64], a mean across the layers) and the [3] gate has a full ``v``."""
    rng = np.random.default_rng(step0 + 1)
    params = _stacked_tree(rng, 0.5)
    params["scan"]["gate"] = params["scan"]["gate"] * 0.001  # scale clamps at eps2
    grads = [_stacked_tree(rng, s) for s in (0.2, 3.0, 0.01)]  # clipped and not
    sched = (1e-2, 5, 100)
    ref = ref_optim.adafactor(ref_optim.warmup_cosine(*sched), weight_decay=weight_decay)
    port = port_optim.adafactor(port_optim.warmup_cosine(*sched), weight_decay=weight_decay,
                                leaves=_stacked_layout())
    r_params = jax.tree.map(jnp.asarray, params)
    r_state = ref.init(r_params)
    p_params = _unstack(params)
    p_state = port.init(p_params)
    assert jax.tree.map(np.shape, jax.tree.map(np.asarray, r_state)) == \
        jax.tree.map(lambda t: tuple(t.shape), p_state)
    assert p_state["scan"]["scale"]["vr"].shape == (3,)
    assert p_state["scan"]["scale"]["vc"].shape == (64,)
    for i, g in enumerate(grads):
        step = step0 + i
        r_upd, r_state = ref.update(jax.tree.map(jnp.asarray, g), r_state, r_params,
                                    jnp.asarray(step))
        p_upd, p_state = port.update(_unstack(g), p_state, p_params, torch.tensor(step))
        want_upd = _unstack(jax.tree.map(np.asarray, r_upd))
        for k in want_upd:
            _close(p_upd[k], want_upd[k], msg=f"update {k} step {step}")
        jax.tree.map(lambda got, want: _close(got, want, msg=f"state step {step}"),
                     p_state, jax.tree.map(np.asarray, r_state))
        r_params = ref_optim.apply_updates(r_params, r_upd)
        port_optim.apply_updates(p_params, p_upd)
    want = _unstack(jax.tree.map(np.asarray, r_params))
    for k in want:
        _close(p_params[k], want[k], msg=f"param {k}")


def test_adafactor_per_layer_leaves_compute_something_else():
    """The control: the same stacked tree updated with every layer as a leaf
    of its own (no ``leaves``) keeps another state and moves the parameters
    differently, so the stacked layout is what the agreement above rests on."""
    rng = np.random.default_rng(2)
    params, g = _stacked_tree(rng, 0.5), _stacked_tree(rng, 0.2)
    ref = ref_optim.adafactor(ref_optim.warmup_cosine(1e-2, 0, 10))
    r_params = jax.tree.map(jnp.asarray, params)
    r_upd, _ = ref.update(jax.tree.map(jnp.asarray, g), ref.init(r_params), r_params,
                          jnp.asarray(3))
    port = port_optim.adafactor(port_optim.warmup_cosine(1e-2, 0, 10))
    p_params = _unstack(params)
    p_state = port.init(p_params)
    assert p_state["scan.0.scale"]["v"].shape == (64,)  # not factored per layer
    p_upd, _ = port.update(_unstack(g), p_state, p_params, torch.tensor(3))
    want = _unstack(jax.tree.map(np.asarray, r_upd))
    assert not np.allclose(p_upd["scan.0.scale"].numpy(), want["scan.0.scale"], **TOL)


def test_adafactor_bf16_params_apply_like_reference():
    """bf16 parameters and gradients: the f32 update is added in f32 and
    rounded once to bf16, as ``(p + u).astype(p.dtype)``."""
    rng = np.random.default_rng(5)
    params = _stacked_tree(rng, 0.5)
    g = _stacked_tree(rng, 0.2)
    sched = (3e-2, 0, 10)
    ref = ref_optim.adafactor(ref_optim.warmup_cosine(*sched))
    r_params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    r_upd, _ = ref.update(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g),
                          ref.init(r_params), r_params, jnp.asarray(2))
    r_new = ref_optim.apply_updates(r_params, r_upd)
    port = port_optim.adafactor(port_optim.warmup_cosine(*sched), leaves=_stacked_layout())
    p_params = {k: v.bfloat16() for k, v in _unstack(params).items()}
    p_grads = {k: v.bfloat16() for k, v in _unstack(g).items()}
    p_upd, _ = port.update(p_grads, port.init(p_params), p_params, torch.tensor(2))
    assert all(u.dtype == torch.float32 for u in p_upd.values())
    port_optim.apply_updates(p_params, p_upd)
    want = _unstack(jax.tree.map(lambda a: np.asarray(a, np.float32), r_new))
    for k, w in want.items():
        assert p_params[k].dtype == torch.bfloat16
        # The updates agree to f32 round-off; a sum that lands within that
        # of a bf16 rounding boundary may round either way: one bf16 ulp.
        _close(p_params[k], w, dict(atol=0, rtol=2 ** -7), msg=k)


# --------------------------------------------------------------------- #
# get_optimizer on a model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["granite-3-2b", "grok-1-314b", "jamba-1.5-large-398b"])
def test_get_optimizer_state_is_the_reference_tree(arch):
    """AdamW's ``m``/``v`` restack onto the reference's parameter tree;
    Adafactor's state is the reference's stacked tree itself, leaf for
    leaf (paths, shapes and dtypes) against the reference's ``init``."""
    ref_cfg = ref_configs.get_smoke_config(arch)
    cfg = port_configs.get_smoke_config(arch)
    specs = ref_model.build_specs(ref_cfg)
    want = jax.eval_shape(lambda: ref_optim.get_optimizer(ref_cfg).init(
        ref_module.init_params(specs, jax.random.PRNGKey(0))))
    model = CausalLM(cfg, device="cpu")
    state = port_optim.get_optimizer(cfg).init(dict(model.named_parameters()))
    if cfg.optimizer == "adamw":
        from repro_torch.models.convert import to_reference

        state = {k: to_reference(cfg, v) for k, v in state.items()}
    assert jax.tree.map(lambda s: (s.shape, np.dtype(s.dtype).name), want) == \
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), state)


def test_reference_leaves_follow_the_reference_tree_order():
    """``reference_leaves`` lists the reference's leaves in its flattening
    order, with each stacked leaf's slices in group order."""
    for arch in ref_configs.ARCHS:
        ref_cfg = ref_configs.get_smoke_config(arch)
        cfg = port_configs.get_smoke_config(arch)
        paths = [tuple(k.key for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(
                     ref_model.build_specs(ref_cfg), is_leaf=ref_module.is_spec)[0]]
        leaves = reference_leaves(cfg)
        assert [leaf.path for leaf in leaves] == paths, arch
        for leaf in leaves:
            layers = [int(k.split("layers.")[1].split(".")[0]) for k in leaf.keys
                      if "layers." in k]
            assert layers == sorted(layers) and len(leaf.keys) == (len(layers) if leaf.stacked
                                                                   else 1), leaf


# --------------------------------------------------------------------- #
# Token sources
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_tokens_bit_identical(seed):
    ref = ref_data.SyntheticTokens(vocab_size=515, seq_len=16, batch=3, seed=seed)
    port = port_data.SyntheticTokens(vocab_size=515, seq_len=16, batch=3, seed=seed)
    for step in (0, 1, 17, 10_000):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for (a, b), _ in zip(zip(iter(ref), iter(port)), range(3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 3)])
def test_memmap_tokens_bit_identical(tmp_path, host_index, host_count):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(1).integers(0, 1000, 17 * 40, dtype=np.int32).tofile(path)
    kw = dict(seq_len=16, batch=3, host_index=host_index, host_count=host_count)
    ref, port = ref_data.MemmapTokens(str(path), **kw), port_data.MemmapTokens(str(path), **kw)
    for step in range(12):
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="too small"):
        port_data.MemmapTokens(str(path), seq_len=16, batch=41)


def test_prefetcher_bit_identical():
    src = port_data.SyntheticTokens(vocab_size=100, seq_len=8, batch=2, seed=4)
    ref_src = ref_data.SyntheticTokens(vocab_size=100, seq_len=8, batch=2, seed=4)
    ref, port = ref_data.Prefetcher(ref_src, start_step=5), port_data.Prefetcher(src, start_step=5)
    try:
        for _ in range(6):
            (s_want, want), (s_got, got) = ref.next(), port.next()
            assert s_got == s_want
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
    finally:
        ref.close()
        port.close()
    assert not port._thread.is_alive()


def test_data_copies_are_the_reference_modules():
    """The port's data modules are the reference's copies: the code equal,
    the module docstring aside."""
    import inspect

    for ref_mod, port_mod in ((ref_data.synthetic, port_data.synthetic),
                              (ref_data.loader, port_data.loader)):
        strip = lambda src: src.split('"""', 2)[2]  # noqa: E731
        assert strip(inspect.getsource(port_mod)) == strip(inspect.getsource(ref_mod))
