"""Differential tests of the port's sharding policy
(``repro_torch.sharding.policy``) and cache spec trees
(``repro_torch.models.blocks.cache_specs_tree``) against the JAX package's
``repro.sharding.policy`` and ``repro.models.blocks``.

The reference resolves on ``jax.sharding.AbstractMesh`` (no devices); the
port on the same axis sizes. Specs, fallback logs (in order), activation
constraints and cache leaves are held exactly equal. The port's caches hold
one layer each: a reference leaf stacked ``[n_groups, ...]`` over a scanned
slot is the port's leaf of each of those layers with its leading entry
dropped, and ``slot_pos`` is int64 where the reference's is int32 (torch
indexes with int64).
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import blocks as ref_blocks
from repro.models.model import build_specs
from repro.models.module import is_spec
from repro.sharding import policy as ref_policy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import fake_process_group, make_device_mesh
from repro_torch.models import blocks
from repro_torch.models.model import CausalLM
from repro_torch.sharding import policy

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}
RULES = ("DEFAULT_RULES", "LONG_DECODE_RULES", "TP_ONLY_RULES", "SERVE_RULES")
CACHE_SHAPES = ((128, 32768), (1, 524288))  # decode_32k, long_500k
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def _is_sd(x):
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple)


def _ref_mesh(name):
    return AbstractMesh(*MESHES[name])


def _port_mesh(name):
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


def _spec(p):
    """A reference PartitionSpec as the port's Spec."""
    return policy.Spec(*tuple(p))


def _leaves_to_resolve(arch):
    """(shape, axes) of every reference parameter leaf and cache leaf."""
    ref_cfg = ref_get_config(arch)
    out = [(s.shape, s.axes) for s in
           jax.tree_util.tree_leaves(build_specs(ref_cfg), is_leaf=is_spec)]
    for batch, max_len in CACHE_SHAPES:
        tree = ref_blocks.cache_specs_tree(ref_cfg, batch, max_len)
        out += [(sd[0], sd[1]) for sd in jax.tree_util.tree_leaves(tree, is_leaf=_is_sd)]
    return out


@pytest.mark.parametrize("rules_name", RULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_equal(arch, rules_name):
    """Every parameter and cache leaf of every published config, on the two
    production meshes and the tests' (4, 2): the same spec and the same
    fallback log, entry by entry."""
    ref_rules, rules = getattr(ref_policy, rules_name), getattr(policy, rules_name)
    assert rules == ref_rules
    leaves = _leaves_to_resolve(arch)
    for mesh_name in MESHES:
        ref_log, log = ref_policy.ResolveLog(), policy.ResolveLog()
        for shape, axes in leaves:
            want = ref_policy.resolve(shape, axes, _ref_mesh(mesh_name), ref_rules, ref_log)
            got = policy.resolve(shape, axes, _port_mesh(mesh_name), rules, log)
            assert got == _spec(want), (mesh_name, shape, axes)
        assert log.replicated == ref_log.replicated
        ref_mesh = _ref_mesh(mesh_name)
        assert policy.data_axes(_port_mesh(mesh_name), rules) == \
            ref_policy.data_axes(ref_mesh, ref_rules)
        assert policy.dp_size(_port_mesh(mesh_name), rules) == \
            ref_policy.dp_size(ref_mesh, ref_rules)


_ACTIVATIONS = [
    ((256, 4096, 2048), ("batch", None, None)),
    ((256, 4096, 8192), ("batch", None, "mlp")),
    ((32, 60, 128, 2048), ("batch", "experts", None, None)),
    ((32, 16, 128, 1408), ("batch", "experts", None, "expert_mlp")),
    ((32, 8, 512, 6144), ("batch", "experts", None, None)),
    ((1, 524288, 8, 128), ("cache_batch", "cache_seq", "kv_heads", None)),
    ((128, 32768, 3072), ("batch", None, "inner")),
    ((12,), ("heads",)),
    ((24,), ("inner",)),
]


@pytest.mark.parametrize("rules_name", RULES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_active_mesh_helpers(mesh_name, rules_name):
    """``logical_spec``, ``filter_spec`` and ``active_dp_size`` under an
    active mesh, and their no-op answers outside one."""
    ref_rules, rules = getattr(ref_policy, rules_name), getattr(policy, rules_name)
    assert policy.active_dp_size() == ref_policy.active_dp_size() == 1
    assert policy.logical_spec((8, 8), ("batch", None)) is None
    assert policy.filter_spec(("data", None)) is None
    with ref_policy.active_mesh(_ref_mesh(mesh_name), ref_rules), \
            policy.active_mesh(_port_mesh(mesh_name), rules):
        assert policy.active_dp_size() == ref_policy.active_dp_size()
        for shape, axes in _ACTIVATIONS:
            want = ref_policy.logical_spec(shape, axes)
            assert policy.logical_spec(shape, axes) == _spec(want), (shape, axes)
        for spec in ((("pod", "data"), None), ("model", "data"), (None, ("data", "model")),
                     ("pod",)):
            want = ref_policy.filter_spec(jax.sharding.PartitionSpec(*spec))
            assert policy.filter_spec(spec) == _spec(want), spec
    assert policy.active_dp_size() == 1


@pytest.mark.parametrize("case", ["two_dims", "joint", "order", "unknown", "twice"])
def test_placements(case):
    """Specs as DTensor placements: a dim sharded over ("pod", "data")
    shards in mesh order; another order, an unknown axis or an axis used
    twice raises."""
    from torch.distributed.tensor import Replicate, Shard

    with fake_process_group(8):
        mesh2 = make_device_mesh((4, 2), ("data", "model"))
        mesh3 = make_device_mesh((2, 2, 2), ("pod", "data", "model"))
        if case == "two_dims":
            assert policy.placements(policy.Spec("model", "data"), mesh2) == (Shard(1), Shard(0))
            assert policy.local_shape((49408, 2048), policy.Spec("model", "data"), mesh2) == \
                (24704, 512)
        elif case == "joint":
            got = policy.placements(policy.Spec(("pod", "data"), None, "model"), mesh3)
            assert got == (Shard(0), Shard(0), Shard(2))
            assert policy.placements(policy.Spec(None, None), mesh3) == (Replicate(),) * 3
        elif case == "order":
            with pytest.raises(ValueError, match="order"):
                policy.placements(policy.Spec(("data", "pod")), mesh3)
        elif case == "unknown":
            with pytest.raises(KeyError):
                policy.placements(policy.Spec("pod"), mesh2)
        else:
            with pytest.raises(ValueError, match="two dims"):
                policy.placements(policy.Spec("data", "data"), mesh2)


def _ref_cache_by_layer(ref_cfg, batch, max_len):
    """The reference's cache spec tree as one dict of (shape, axes, dtype)
    per layer: scanned leaves sliced along their leading axis."""
    period, n_groups, _kinds, tail = ref_blocks.stack_layout(ref_cfg)
    tree = ref_blocks.cache_specs_tree(ref_cfg, batch, max_len)
    layers = [None] * (n_groups * period + len(tail))

    def unstack(t):
        if _is_sd(t):
            return (t[0][1:], t[1][1:], t[2])
        return {k: unstack(v) for k, v in t.items()}

    for i in range(period if n_groups else 0):
        for g in range(n_groups):
            layers[g * period + i] = unstack(tree["scan"][f"slot{i}"])
    for j in range(len(tail)):
        layers[n_groups * period + j] = tree["tail"][f"layer{j}"]
    return layers


def _flat(tree, path=()):
    if _is_sd(tree):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    for batch, max_len in CACHE_SHAPES:
        want = _ref_cache_by_layer(ref_get_config(arch), batch, max_len)
        got = blocks.cache_specs_tree(get_config(arch), batch, max_len)
        assert len(got) == len(want)
        for layer, (g, w) in enumerate(zip(got, want)):
            g, w = _flat(g), _flat(w)
            assert set(g) == set(w), layer
            for path in w:
                dtype = torch.long if path[-1] == "slot_pos" else _DTYPES[jnp.dtype(w[path][2]).name]
                assert g[path] == (tuple(w[path][0]), tuple(w[path][1]), dtype), (layer, path)


def _tensor_leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_tensor_leaves(v, path + (k,)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_prefill(arch):
    """The spec tree has the leaves, shapes and dtypes of the caches that
    ``CausalLM.prefill`` returns (smoke configs, meta tensors)."""
    cfg = get_smoke_config(arch)
    batch, seq, max_len = 2, 8, 12
    model = CausalLM(cfg, device="meta")
    extras = None
    if cfg.encoder is not None:
        extras = {"frames": torch.empty(batch, cfg.encoder.n_frames, cfg.d_model,
                                        dtype=cfg.dtype, device="meta")}
    elif cfg.cross_attn_every is not None:
        extras = {"vision_embeds": torch.empty(batch, cfg.n_vision_tokens, cfg.d_model,
                                               dtype=cfg.dtype, device="meta")}
    tokens = torch.empty(batch, seq, dtype=torch.long, device="meta")
    _logits, caches = model.prefill(tokens, extras, max_len=max_len)
    specs = blocks.cache_specs_tree(cfg, batch, max_len)
    assert len(caches) == len(specs)
    for layer, (c, s) in enumerate(zip(caches, specs)):
        got, want = _tensor_leaves(c), _flat(s)
        assert set(got) == set(want), layer
        for path, t in got.items():
            assert (tuple(t.shape), t.dtype) == (want[path][0], want[path][2]), (layer, path)
