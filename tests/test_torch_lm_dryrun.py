"""Differential tests of the port's LM dry-run (``repro_torch.launch.specs``,
``repro_torch.launch.dryrun``, the DTensor paths of the models and the
tally's DTensor accounting) against the JAX package's ``repro.launch.specs``
and ``repro.models.moe``.

The reference's specs are built in process on ``jax.sharding.AbstractMesh``;
the reference's dry-run module sets ``XLA_FLAGS`` on import, so it is only
run in a child interpreter. The port runs as rank 0 of one fake 512-rank
process group for the module (its meshes lie over its first ranks).

The traced cells are the reference's ``tests/test_dryrun_small.py`` four on a
(4, 2) mesh, with the depth cut to one pattern period (and one encoder
layer) to stay inside the test's time; the CLI test runs a full cell.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from distributed_helpers import run_with_devices
from repro.configs import cells as ref_cells
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch.specs import input_specs as ref_input_specs
from repro.models import moe as ref_moe
from repro.models.module import init_params as ref_init_params
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun, specs as port_specs
from repro_torch.launch.mesh import fake_process_group, make_device_mesh
from repro_torch.launch.steps import step_fn_for
from repro_torch.models import moe as port_moe
from repro_torch.models.blocks import pattern_period, stack_layout
from repro_torch.models.convert import reference_leaves
from repro_torch.models.layers import with_logical
from repro_torch.models.module import SpecModule, meta_dtensor
from repro_torch.models.parity import F32_TOL
from repro_torch.roofline.tally import Tally, repeated
from repro_torch.sharding.policy import Spec, active_dp_size, active_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    with fake_process_group(512):
        yield


# --------------------------------------------------------------------- #
# Input specs: the port's meta DTensors against the reference's structs
# --------------------------------------------------------------------- #
def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _check(port, ref, path, sliced=False):
    """Shape, dtype and rank 0's shard shape of a port tensor against a
    reference ShapeDtypeStruct (``sliced``: one slice of a stacked leaf)."""
    shape = tuple(ref.shape)
    local = shape if ref.sharding is None else tuple(ref.sharding.shard_shape(ref.shape))
    if sliced:
        shape, local = shape[1:], local[1:]
    dtype = torch.long if path[-1] == "slot_pos" else _DTYPES[jnp.dtype(ref.dtype).name]
    got_local = tuple(port.to_local().shape) if hasattr(port, "to_local") else tuple(port.shape)
    assert (tuple(port.shape), port.dtype, got_local) == (shape, dtype, local), path


def _ref_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _ref_leaves(v, path + (k,))
    else:
        yield path, tree


def _check_params(cfg, params, ref_params, prefix=()):
    """The port's per-layer parameters against the reference's (stacked)
    tree, leaf by leaf."""
    n = 0
    for leaf in reference_leaves(cfg):
        ref = _node(ref_params, leaf.path)
        for key in leaf.keys:
            _check(params[key], ref, prefix + leaf.path, sliced=leaf.stacked)
            n += 1
    assert n == len(params)


def _check_caches(cfg, caches, ref_caches):
    period, n_groups, _kinds, tail = stack_layout(cfg)
    assert len(caches) == n_groups * period + len(tail)
    for layer, cache in enumerate(caches):
        if layer < n_groups * period:
            ref, sliced = ref_caches["scan"][f"slot{layer % period}"], True
        else:
            ref, sliced = ref_caches["tail"][f"layer{layer - n_groups * period}"], False
        ref_flat = dict(_ref_leaves(ref))
        port_flat = dict(_ref_leaves(cache))
        assert set(port_flat) == set(ref_flat), layer
        for path, r in ref_flat.items():
            _check(port_flat[path], r, ("caches", layer) + path, sliced=sliced)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", ref_cells())
def test_input_specs_equal(arch, shape_name, mesh_name):
    """Every cell on both production meshes: the same inputs (keys, shapes,
    dtypes and rank 0's shard shapes, the port's layers as slices of the
    reference's stacked leaves) and the same fallback log."""
    shape, axes = MESHES[mesh_name]
    ref, _ref_cfg, ref_log = ref_input_specs(arch, shape_name, AbstractMesh(shape, axes))
    got, cfg, log = port_specs.input_specs(arch, shape_name, make_device_mesh(shape, axes))
    assert set(got) == {"model" if k == "params" else k for k in ref}
    assert log.replicated == ref_log.replicated
    assert log.ops == []
    _check_params(cfg, dict(got["model"].named_parameters()), ref["params"])
    for key in set(ref) - {"params", "opt_state", "caches"}:
        ref_flat, port_flat = dict(_ref_leaves(ref[key])), dict(_ref_leaves(got[key]))
        assert set(port_flat) == set(ref_flat), key
        for path, r in ref_flat.items():
            _check(port_flat[path], r, (key,) + path)
    if "opt_state" in ref:
        if cfg.optimizer == "adamw":
            for moment in ("m", "v"):
                _check_params(cfg, got["opt_state"][moment], ref["opt_state"][moment], (moment,))
        else:
            ref_flat, port_flat = dict(_ref_leaves(ref["opt_state"])), \
                dict(_ref_leaves(got["opt_state"]))
            assert set(port_flat) == set(ref_flat)
            for path, r in ref_flat.items():
                _check(port_flat[path], r, ("opt_state",) + path)
    if "caches" in ref:
        _check_caches(cfg, got["caches"], ref["caches"])


# --------------------------------------------------------------------- #
# MoE dispatch groups under a mesh
# --------------------------------------------------------------------- #
_REF_MOE_CHILD = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_smoke_config
from repro.models import moe
from repro.models.module import init_params
from repro.sharding.policy import active_dp_size, active_mesh

cfg = get_smoke_config("qwen2-moe-a2.7b")
cfg = dataclasses.replace(cfg, dtype=jnp.float32,
                          moe=dataclasses.replace(cfg.moe, capacity_factor=CF))
params = init_params(moe.moe_specs(cfg), jax.random.PRNGKey(3))
x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model), dtype=np.float32)
mesh = make_mesh((4, 2), ("data", "model"))
with mesh, active_mesh(mesh):
    assert active_dp_size() == 4 and moe._dispatch_groups(32) == 4
    out, aux = jax.jit(lambda p, x: moe.moe(p, x, cfg))(params, jnp.asarray(x))
np.savez(sys.argv[1], out=np.asarray(out), aux=np.asarray(aux), x=x,
         **{"/".join(map(str, (k.key for k in path))): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
"""


# A capacity factor low enough that slots are dropped: per-group capacities
# then decide which tokens reach an expert (with one group in place of the
# mesh's four, 448 of the 2,048 outputs differ).
MOE_CF = 0.5


def _moe_module(cfg, arrays):
    mod = SpecModule(port_moe.moe_specs(cfg), "cpu")
    mod.load_state_dict({k.replace("/", "."): torch.from_numpy(np.array(v)) for k, v in arrays.items()
                         if k not in ("out", "aux", "x")})
    return mod


@pytest.mark.parametrize("on_mesh", [True, False])
def test_moe_dispatch_groups(on_mesh, tmp_path):
    """Under a (4, 2) mesh tokens dispatch within active_dp_size() = 4 groups
    (the reference's ``_dispatch_groups``), each with its own capacity: the
    port on plain CPU tensors (``with_logical`` leaves them as they are)
    against the reference in a child on 8 host devices; without a mesh one
    group, as on one card."""
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, dtype=torch.float32,
                              moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_CF))
    if on_mesh:
        path = str(tmp_path / "ref.npz")
        run_with_devices(_REF_MOE_CHILD.replace("sys.argv[1]", repr(path))
                         .replace("CF", repr(MOE_CF)), n_devices=8)
        arrays = dict(np.load(path))
    else:
        ref_cfg = ref_smoke_config("qwen2-moe-a2.7b")
        ref_cfg = dataclasses.replace(ref_cfg, dtype=jnp.float32, moe=dataclasses.replace(
            ref_cfg.moe, capacity_factor=MOE_CF))
        params = ref_init_params(ref_moe.moe_specs(ref_cfg), jax.random.PRNGKey(3))
        x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model), dtype=np.float32)
        out, aux = ref_moe.moe(params, jnp.asarray(x), ref_cfg)
        arrays = {"out": np.asarray(out), "aux": np.asarray(aux), "x": x}
        arrays.update({"/".join(str(k.key) for k in p): np.asarray(v)
                       for p, v in jax.tree_util.tree_flatten_with_path(params)[0]})
    mod, x = _moe_module(cfg, arrays), torch.from_numpy(arrays["x"])
    if on_mesh:
        with active_mesh(make_device_mesh((4, 2), ("data", "model"))):
            assert active_dp_size() == 4 and port_moe._dispatch_groups(32) == 4
            assert with_logical(x, ("batch", None, None)) is x
            got, got_aux = port_moe.moe(mod, x, cfg)
    else:
        assert port_moe._dispatch_groups(32) == 1
        got, got_aux = port_moe.moe(mod, x, cfg)
    np.testing.assert_allclose(got.numpy(), arrays["out"], **F32_TOL)
    np.testing.assert_allclose(float(got_aux), float(arrays["aux"]), **F32_TOL)


# --------------------------------------------------------------------- #
# Traced steps on a (4, 2) mesh, and the tally's pricing
# --------------------------------------------------------------------- #
def _cut(name):
    cfg = get_config(name)
    kw = {"n_layers": pattern_period(cfg)}
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=1)
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("arch,shape_name", [
    ("granite-3-2b", "train_4k"),
    ("qwen2-moe-a2.7b", "prefill_32k"),
    ("mamba2-130m", "decode_32k"),
    ("whisper-small", "decode_32k"),
])
def test_traced_cell_small_mesh(arch, shape_name, monkeypatch):
    monkeypatch.setattr(port_specs, "get_config", _cut)
    mesh = make_device_mesh((4, 2), ("data", "model"))
    specs, cfg, log = port_specs.input_specs(arch, shape_name, mesh)
    kind = SHAPES[shape_name].kind
    fn, order = step_fn_for(cfg, kind, accum_steps=2 if kind == "train" else 1,
                            microbatch_repeat=repeated)
    tally, _out = dryrun.trace_step(fn, {k: specs[k] for k in order}, mesh,
                                    port_specs.rules_for(cfg, shape_name), log)
    assert tally.flops > 0
    assert tally.peak_bytes > 0 and tally.hbm_bytes > 0
    if kind == "train":
        assert sum(tally.collectives.count.values()) > 0
        assert tally.collectives.count.get("reduce-scatter", 0) > 0  # ZeRO gradients
        # The one explicit replicate site: the microbatch split's view.
        assert log.ops == [("aten.view", "runtime/train_loop.py::make_train_step")]
    else:
        assert log.ops == []


def test_fsdp_all_gather_wire_bytes():
    """A weight sharded over "data" (4 ranks of one node) gathered whole:
    one all-gather of 64 x 32 f32 = 8,192 bytes, 3/4 of it on the wire per
    rank, on NVLink."""
    from torch.distributed.tensor import Replicate

    mesh = make_device_mesh((4, 2), ("data", "model"))
    w = meta_dtensor((64, 32), torch.float32, mesh, Spec("data", None))
    with Tally() as tally:
        full = w.redistribute(mesh, [Replicate(), Replicate()])
    assert full.to_local().shape == (64, 32)
    c = tally.collectives
    assert (c.count, c.op_bytes, c.wire_bytes, c.link_wire_bytes) == (
        {"all-gather": 1}, {"all-gather": 8192}, {"all-gather": 6144}, {"nvlink": 6144})


def test_cli_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one full cell: the final
    line, and a record with the reference's keys under the renames."""
    ref_keys = {"arch", "shape", "kind", "mesh", "n_chips", "params", "active_params",
                "accum_steps", "lower_s", "compile_s", "flops_per_device", "bytes_per_device",
                "hlo_flops_per_device_loopblind", "hlo_bytes_per_device_loopblind",
                "analytic_detail", "memory_analysis", "memory_model", "fits_16gb",
                "collectives", "roofline", "replicated_fallbacks"}
    renames = {"compile_s": "trace_s", "hlo_flops_per_device_loopblind": "flops",
               "hlo_bytes_per_device_loopblind": "hbm_bytes", "fits_16gb": "fits_80gb"}
    out_dir = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-130m",
         "--shape", "decode_32k", "--artifact-dir", out_dir],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "all dry-run cells traced OK"
    with open(os.path.join(out_dir, "mamba2-130m__decode_32k__16x16.json")) as f:
        rec = json.load(f)
    assert set(rec) == {renames.get(k, k) for k in ref_keys}
    assert rec["n_chips"] == 256 and rec["flops"] > 0
    assert set(rec["memory_analysis"]) == {"argument_bytes", "output_bytes",
                                           "peak_temp_bytes", "peak_bytes"}
