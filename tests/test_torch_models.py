"""The port's LM models (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package's, on the CPU.

Each test draws the reference's parameters with ``init_params(...,
PRNGKey(seed))``, carries them across as numpy arrays
(``repro_torch.models.convert.from_reference``, or a module's own keys),
feeds the same numpy inputs to both packages and compares:

* per module: the norms, RoPE (full and partial), the bf16 token embedding,
  SwiGLU and GELU, attention (full, chunked, windowed, cross), the chunked
  SSD over the reference's grid of chunk and sequence lengths, and the MoE
  with capacity drops and shared experts;
* per architecture at ``smoke_config()``: the forward logits, and prefill
  followed by 8 decode steps; every cross gate is set nonzero first (its
  init is zeros, which would leave the cross-attention and encoder paths
  unchecked);
* gemma3's 24-token prefill into its 8-slot window, qwen3-8b at its
  published widths (one layer, a 4,096-token vocab), bf16 activations, and
  the parameter count and leaf shapes of every published configuration;
* ``ce_loss`` (the padded-vocab mask, z-loss) and ``loss_fn`` (the MoE aux
  weight, the encoder source).

Tolerances (``repro_torch.models.parity``): f32 logits within atol 1e-4 and
rtol 1e-4, or within the reference's own movement under a one-ulp change of
its parameters where that is larger (``arch_pair``); decode against a full forward within the
reference's own (``tests/test_decode_long.py``: atol 2e-3, rtol 1e-3); bf16
as stated at its test.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import mlp as ref_mlp
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models import module as ref_module
from repro.models import ssm as ref_ssm
from repro_torch import configs as port_configs
from repro_torch.configs import base as port_base
from repro_torch.models import attention as port_attn
from repro_torch.models import layers as port_layers
from repro_torch.models import mlp as port_mlp
from repro_torch.models import moe as port_moe
from repro_torch.models import ssm as port_ssm
from repro_torch.models.convert import _leaves, from_reference
from repro_torch.models import model as port_model_lib
from repro_torch.models.model import CausalLM
from repro_torch.models.module import SpecModule, count_params
from repro_torch.models.parity import DECODE_TOL, F32_TOL, f32_tolerance, ulp_perturbed

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ARCHS = ref_configs.ARCHS
F32 = F32_TOL
DECODE = DECODE_TOL  # the reference's decode-parity tolerance
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


# --------------------------------------------------------------------- #
# Helpers shared with test_torch_serve_lm.py
# --------------------------------------------------------------------- #
def port_config(ref_cfg):
    """The port's ``ModelConfig`` equal to a reference one (torch dtypes)."""
    sub = {ref_base.MoEConfig: port_base.MoEConfig, ref_base.SSMConfig: port_base.SSMConfig,
           ref_base.EncoderConfig: port_base.EncoderConfig}
    kw = {}
    for f in dataclasses.fields(ref_cfg):
        v = getattr(ref_cfg, f.name)
        if type(v) in sub:
            v = sub[type(v)](**dataclasses.asdict(v))
        elif f.name in ("dtype", "param_dtype"):
            v = _DTYPES[v]
        kw[f.name] = v
    return port_base.ModelConfig(**kw)


def ref_params(ref_cfg, seed, cross_gate=True):
    """The reference's parameters as numpy leaves, with every cross gate set
    to a distinct nonzero value when ``cross_gate``."""
    tree = jax.tree.map(np.asarray, ref_module.init_params(ref_model.build_specs(ref_cfg),
                                                           jax.random.PRNGKey(seed)))
    if cross_gate:
        rng = np.random.default_rng(seed)

        def walk(t):
            for k, v in t.items():
                if k == "cross_gate":
                    t[k] = rng.uniform(0.3, 1.5, v.shape).astype(v.dtype)
                elif isinstance(v, dict):
                    walk(v)
        walk(tree)
    return tree


def port_model(cfg, tree):
    model = CausalLM(cfg, device="cpu")
    model.load_state_dict(from_reference(cfg, tree))
    return model


def module_of(specs, tree):
    """A ``SpecModule`` of ``specs`` holding the reference's numpy ``tree``."""
    mod = SpecModule(specs, "cpu")
    mod.load_state_dict({".".join(p): torch.from_numpy(np.array(v, dtype=np.float32))
                         .to(dict(mod.state_dict())[".".join(p)].dtype)
                         for p, v in _leaves(tree)})
    return mod


def extras_np(cfg, batch, seed=7):
    rng = np.random.default_rng(seed)
    if cfg.encoder is not None:
        return {"frames": rng.standard_normal((batch, cfg.encoder.n_frames, cfg.d_model),
                                              dtype=np.float32)}
    if cfg.cross_attn_every is not None:
        return {"vision_embeds": rng.standard_normal((batch, cfg.n_vision_tokens, cfg.d_model),
                                                     dtype=np.float32)}
    return None


def to_jax(extras, ref_cfg):
    return None if extras is None else {k: jnp.asarray(v, ref_cfg.dtype) for k, v in extras.items()}


def to_torch(extras, cfg):
    return None if extras is None else {k: torch.from_numpy(v).to(cfg.dtype)
                                        for k, v in extras.items()}


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()) if isinstance(got, torch.Tensor)
                               else np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------------- #
# Import hygiene and the configurations
# --------------------------------------------------------------------- #
def test_lm_port_imports_neither_jax_nor_repro():
    """Every repro_torch module, the LM ones among them, imports in a fresh
    interpreter without pulling in JAX, the JAX package or ``ml_dtypes``."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'jaxlib', 'repro', 'ml_dtypes')\n"
        "             or k.startswith(('jax.', 'jaxlib.', 'repro.', 'ml_dtypes.')))\n"
        "need = ['repro_torch.configs.' + a for a in ('base', 'qwen3_8b', 'grok1_314b',\n"
        "        'jamba15_large_398b', 'whisper_small')]\n"
        "need += ['repro_torch.models.' + m for m in ('module', 'layers', 'mlp', 'attention',\n"
        "         'ssm', 'moe', 'blocks', 'model', 'convert', 'parity')]\n"
        "need += ['repro_torch.runtime.serve_loop', 'repro_torch.launch.serve']\n"
        "missing = [m for m in need if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_mirror_reference(arch):
    assert port_configs.get_config(arch) == port_config(ref_configs.get_config(arch))
    assert port_configs.get_smoke_config(arch) == port_config(ref_configs.get_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_leaf_shapes_of_published_config(arch):
    """The model built on ``meta`` has the reference's spec count, and every
    reference leaf (a ``meta`` tensor of the spec's shape and dtype) maps
    onto a parameter of that shape."""
    ref_cfg = ref_configs.get_config(arch)
    cfg = port_configs.get_config(arch)
    specs = ref_model.build_specs(ref_cfg)
    assert count_params(CausalLM(cfg, device="meta")) == ref_module.count_params(specs)
    assert cfg.param_count_estimate() == ref_module.count_params(specs)
    meta = jax.tree.map(lambda s: torch.empty(s.shape, dtype=_DTYPES[s.dtype], device="meta"),
                        specs, is_leaf=ref_module.is_spec)
    sd = from_reference(cfg, meta)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in CausalLM(cfg, device="meta").state_dict().items()}


def test_from_reference_rejects_missing_extra_and_misshapen_leaves():
    ref_cfg = ref_configs.get_smoke_config("jamba-1.5-large-398b")
    cfg = port_configs.get_smoke_config("jamba-1.5-large-398b")
    tree = ref_params(ref_cfg, 0)
    port_model(cfg, tree)  # the whole tree carries
    missing = jax.tree.map(lambda x: x, tree)
    del missing["final_norm"]
    with pytest.raises(KeyError, match="no reference leaf"):
        from_reference(cfg, missing)
    extra = jax.tree.map(lambda x: x, tree)
    extra["stack"]["scan"]["slot0"]["bogus"] = np.zeros((1, 3), np.float32)
    with pytest.raises(KeyError, match="bogus"):
        from_reference(cfg, extra)
    bad = jax.tree.map(lambda x: x, tree)
    bad["final_norm"]["scale"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        from_reference(cfg, bad)


# --------------------------------------------------------------------- #
# Per module
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms(kind, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32) * 3
    tree = {"scale": rng.standard_normal(48, dtype=np.float32),
            "bias": rng.standard_normal(48, dtype=np.float32)}
    if kind == "rms":
        del tree["bias"]
    ref_fn, port_fn, specs = ((ref_layers.rmsnorm, port_layers.rmsnorm, port_layers.rmsnorm_specs)
                              if kind == "rms" else (ref_layers.layernorm, port_layers.layernorm,
                                                     port_layers.layernorm_specs))
    want = ref_fn(jax.tree.map(jnp.asarray, tree), jnp.asarray(x, dtype), 1e-5)
    got = port_fn(module_of(specs(48), tree), torch.from_numpy(x).to(_DTYPES[dtype]), 1e-5)
    assert got.dtype == _DTYPES[dtype]
    tol = F32 if dtype == jnp.float32 else dict(atol=0, rtol=2 ** -7)  # one bf16 rounding
    close(got, want, **tol)


@pytest.mark.parametrize("fraction,theta", [(1.0, 1_000_000.0), (0.75, 10_000.0)])
def test_rope(fraction, theta):
    """Full RoPE (qwen3) and phi4's partial rotary (3/4 of the head)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16), dtype=np.float32)
    pos = (np.arange(9)[None] + np.array([[0], [100]])).astype(np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction)
    got = port_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(), theta,
                                 fraction)
    close(got, want, **F32)
    rot = int(16 * fraction) // 2 * 2
    np.testing.assert_array_equal(got[..., rot:].numpy(), x[..., rot:])


def test_embed_tokens_bf16_scale_rounding():
    """bf16 at d_model 2,048: the scale is sqrt(2048) rounded to bf16
    (45.25, not 45.2548), and the embeddings equal the reference's bit for
    bit."""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("qwen3-8b"), d_model=2048,
                                  dtype=jnp.bfloat16)
    cfg = port_config(ref_cfg)
    assert port_layers.embed_scale(cfg) == 45.25
    tree = jax.tree.map(np.asarray, ref_module.init_params(ref_layers.embedding_specs(ref_cfg),
                                                           jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    want = ref_layers.embed_tokens(jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), ref_cfg)
    got = port_layers.embed_tokens(module_of(port_layers.embedding_specs(cfg), tree),
                                   torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlps(kind):
    ref_cfg = ref_configs.get_smoke_config("qwen3-8b" if kind == "swiglu" else "whisper-small")
    cfg = port_config(ref_cfg)
    ref_specs, port_specs, ref_fn, port_fn = (
        (ref_mlp.swiglu_specs, port_mlp.swiglu_specs, ref_mlp.swiglu, port_mlp.swiglu)
        if kind == "swiglu" else
        (ref_mlp.gelu_mlp_specs, port_mlp.gelu_mlp_specs, ref_mlp.gelu_mlp, port_mlp.gelu_mlp))
    tree = jax.tree.map(np.asarray, ref_module.init_params(
        ref_specs(cfg.d_model, cfg.d_ff, jnp.float32), jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    for k in ("bi", "bo"):  # zeros at init; make the biases count
        if k in tree:
            tree[k] = rng.standard_normal(tree[k].shape, dtype=np.float32)
    x = rng.standard_normal((2, 6, cfg.d_model), dtype=np.float32)
    want = ref_fn(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), ref_cfg)
    got = port_fn(module_of(port_specs(cfg.d_model, cfg.d_ff, torch.float32), tree),
                  torch.from_numpy(x), cfg)
    close(got, want, **F32)


def _attn_cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=64, dtype=jnp.float32, attn_chunk=16,
                qk_norm=True)
    base.update(kw)
    ref_cfg = ref_base.ModelConfig(**base)
    return ref_cfg, port_config(ref_cfg)


@pytest.mark.parametrize("impl,window,cross", [
    ("full", None, False), ("chunked", None, False), ("full", 8, False),
    ("chunked", 8, False), ("full", None, True),
])
def test_attention(impl, window, cross):
    """Full and chunked (online softmax) attention, a sliding window of 8,
    and cross-attention to a 24-token source; the cached (k, v) too."""
    ref_cfg, cfg = _attn_cfgs(attention_impl=impl)
    tree = jax.tree.map(np.asarray, ref_module.init_params(
        ref_attn.attention_specs(ref_cfg, cross=cross), jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    seq = 64
    x = rng.standard_normal((2, seq, 64), dtype=np.float32)
    src = rng.standard_normal((2, 24, 64), dtype=np.float32) if cross else None
    pos = np.broadcast_to(np.arange(seq), (2, seq))
    kw = dict(causal=not cross, window=window)
    want, (wk, wv) = ref_attn.attention(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), ref_cfg,
        positions=jnp.asarray(pos, jnp.int32),
        kv_src=None if src is None else jnp.asarray(src), **kw)
    got, (gk, gv) = port_attn.attention(
        module_of(port_attn.attention_specs(cfg, cross=cross), tree), torch.from_numpy(x), cfg,
        positions=torch.from_numpy(pos.copy()),
        kv_src=None if src is None else torch.from_numpy(src), **kw)
    close(got, want, **F32)
    close(gk, wk, **F32)
    close(gv, wv, **F32)


@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
@pytest.mark.parametrize("seq", [16, 33, 64])
def test_ssd_chunked(chunk, seq):
    """The reference's grid: the port's chunked SSD against the reference's
    (output and final state) and against the sequential oracle."""
    rng = np.random.default_rng(chunk * 100 + seq)
    b, h, p, n = 2, 3, 8, 4
    x = rng.standard_normal((b, seq, h, p), dtype=np.float32)
    B = rng.standard_normal((b, seq, n), dtype=np.float32)
    C = rng.standard_normal((b, seq, n), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, seq, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    want_y, want_h = ref_ssm.ssd_chunked(*map(jnp.asarray, (x, B, C, dt, A)), chunk=chunk)
    args = [torch.from_numpy(a) for a in (x, B, C, dt, A)]
    got_y, got_h = port_ssm.ssd_chunked(*args, chunk=chunk)
    close(got_y, want_y, atol=2e-4, rtol=2e-4)
    close(got_h, want_h, atol=2e-4, rtol=2e-4)
    close(got_y, port_ssm.ssd_sequential_ref(*args), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("cf,n_shared", [(0.25, 0), (1.25, 2), (16.0, 0)])
def test_moe(cf, n_shared):
    """Capacity drops (0.25: most slots dropped), the default factor with
    shared experts, and no drops; the aux loss too."""
    ref_cfg = ref_base.ModelConfig(
        name="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=0, vocab_size=64, dtype=jnp.float32,
        moe=ref_base.MoEConfig(n_experts=8, top_k=2, d_expert=16, capacity_factor=cf,
                               n_shared=n_shared, d_shared=32 if n_shared else 0))
    cfg = port_config(ref_cfg)
    tree = jax.tree.map(np.asarray, ref_module.init_params(ref_moe.moe_specs(ref_cfg),
                                                           jax.random.PRNGKey(5)))
    x = np.random.default_rng(5).standard_normal((2, 32, 32), dtype=np.float32)
    want, want_aux = ref_moe.moe(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), ref_cfg)
    got, got_aux = port_moe.moe(module_of(port_moe.moe_specs(cfg), tree), torch.from_numpy(x),
                                cfg)
    close(got, want, **F32)
    close(got_aux, want_aux, **F32)
    if cf < 1:
        assert float((got.abs().sum(-1) == 0).float().mean()) > 0.1  # rows dropped


# --------------------------------------------------------------------- #
# Per architecture, smoke configs
# --------------------------------------------------------------------- #
B, S, N_DECODE = 2, 16, 8


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    """One architecture at its smoke config: the reference's cfg, params
    (jax arrays) and forward logits, the port's cfg and model, the tokens,
    the extras, and the f32 tolerance.

    The tolerance is atol 1e-4 and rtol 1e-4, or, where larger, the
    reference's own movement when its f32 parameters move by one ulp: these
    random-init models amplify round-off (whisper's attention has no
    qk-norm and scores in the hundreds), and the port cannot be nearer the
    reference than the reference is to itself. Seen: granite-3-2b 1.5e-4,
    phi4 1.0e-4, whisper-small 1.4e-2 (logits up to 31.5); the port's
    differences were 1.4e-4, 8.7e-5 and 4.8e-3."""
    arch = request.param
    ref_cfg = ref_configs.get_smoke_config(arch)
    cfg = port_configs.get_smoke_config(arch)
    tree = ref_params(ref_cfg, 0)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + N_DECODE))
    ex = extras_np(cfg, B)
    fwd = jax.jit(ref_model.forward, static_argnums=2)
    params = jax.tree.map(jnp.asarray, tree)
    want = fwd(params, jnp.asarray(tokens, jnp.int32), ref_cfg, to_jax(ex, ref_cfg))
    moved = fwd(jax.tree.map(jnp.asarray, ulp_perturbed(tree)), jnp.asarray(tokens, jnp.int32),
                ref_cfg, to_jax(ex, ref_cfg))[0]
    tol = f32_tolerance(want[0], moved)
    return ref_cfg, params, want, cfg, port_model(cfg, tree), tokens, ex, tol


def test_arch_forward(arch_pair):
    _ref_cfg, _params, (want, want_aux, _), cfg, model, tokens, ex, tol = arch_pair
    got, got_aux, _ = model(torch.from_numpy(tokens), to_torch(ex, cfg))
    assert got.shape == (B, S + N_DECODE, cfg.vocab_padded)
    close(got, want, **tol)
    close(got_aux, want_aux, **F32)


def test_arch_prefill_and_decode(arch_pair):
    """Prefill S tokens, then 8 decode steps, each step's logits against the
    reference's step; then the port's own steps against its full forward."""
    ref_cfg, params, _want, cfg, model, tokens, ex, tol = arch_pair
    max_len = S + N_DECODE
    want, caches = jax.jit(ref_model.prefill, static_argnums=2, static_argnames="max_len")(
        params, jnp.asarray(tokens[:, :S], jnp.int32), ref_cfg, to_jax(ex, ref_cfg),
        max_len=max_len)
    got, pcaches = model.prefill(torch.from_numpy(tokens[:, :S]), to_torch(ex, cfg),
                                 max_len=max_len)
    close(got, want, **tol)
    step = jax.jit(ref_model.decode_step, static_argnums=4)
    full, _, _ = model(torch.from_numpy(tokens), to_torch(ex, cfg))
    for t in range(N_DECODE):
        tok = tokens[:, S + t:S + t + 1]
        want, caches = step(params, caches, jnp.asarray(tok, jnp.int32),
                            jnp.full((B,), S + t, jnp.int32), ref_cfg)
        got, pcaches = model.decode_step(pcaches, torch.from_numpy(tok),
                                         torch.full((B,), S + t))
        close(got, want, err_msg=f"step {t}", **tol)
        if cfg.moe is None:  # MoE capacity differs between 2 and 48 tokens
            close(got[:, 0], full[:, S + t], err_msg=f"step {t} vs forward", **DECODE)


def test_sliding_window_prefill_longer_than_ring():
    """gemma3's smoke config (window 8) prefills 24 tokens, so 16 of them
    share ring slots with later ones; 12 decode steps then wrap the ring.
    Each step matches the reference's and the port's full forward."""
    ref_cfg = ref_configs.get_smoke_config("gemma3-27b")
    cfg = port_configs.get_smoke_config("gemma3-27b")
    tree = ref_params(ref_cfg, 0)
    params = jax.tree.map(jnp.asarray, tree)
    model = port_model(cfg, tree)
    b, s, n = 2, 24, 12
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s + n))
    _, caches = ref_model.prefill(params, jnp.asarray(tokens[:, :s], jnp.int32), ref_cfg,
                                  max_len=s + n)
    _, pcaches = model.prefill(torch.from_numpy(tokens[:, :s]), max_len=s + n)
    local = next(c["attn"] for c, blk in zip(pcaches, model.layers) if blk.kind.window)
    ref_local = caches["scan"]["slot0"]["attn"]
    np.testing.assert_array_equal(local["slot_pos"].numpy(), np.asarray(ref_local["slot_pos"][0]))
    close(local["k"], ref_local["k"][0], **F32)
    full, _, _ = model(torch.from_numpy(tokens))
    step = jax.jit(ref_model.decode_step, static_argnums=4)
    for t in range(n):
        tok = tokens[:, s + t:s + t + 1]
        want, caches = step(params, caches, jnp.asarray(tok, jnp.int32),
                            jnp.full((b,), s + t, jnp.int32), ref_cfg)
        got, pcaches = model.decode_step(pcaches, torch.from_numpy(tok), torch.full((b,), s + t))
        close(got, want, err_msg=f"step {t}", **F32)
        close(got[:, 0], full[:, s + t], err_msg=f"step {t} vs forward", **DECODE)


def test_qwen3_8b_published_widths_one_layer():
    """qwen3-8b at its published widths (d_model 4,096, 32 q / 8 kv heads of
    128, d_ff 12,288, qk-norm, untied), one layer and a 4,096-token vocab,
    f32, B=1, S=16: the forward logits, and 4 decode steps after a prefill."""
    ref_cfg = dataclasses.replace(ref_configs.get_config("qwen3-8b"), n_layers=1,
                                  vocab_size=4096, dtype=jnp.float32)
    cfg = port_config(ref_cfg)
    tree = ref_params(ref_cfg, 0)
    params = jax.tree.map(jnp.asarray, tree)
    model = port_model(cfg, tree)
    del tree
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 16))
    want, _, _ = jax.jit(ref_model.forward, static_argnums=2)(
        params, jnp.asarray(tokens, jnp.int32), ref_cfg)
    got, _, _ = model(torch.from_numpy(tokens))
    close(got, want, **F32)
    _, pcaches = model.prefill(torch.from_numpy(tokens[:, :12]), max_len=16)
    for t in range(12, 16):
        lg, pcaches = model.decode_step(pcaches, torch.from_numpy(tokens[:, t:t + 1]),
                                        torch.full((1,), t))
        close(lg[:, 0], want[:, t], err_msg=f"position {t}", **DECODE)


# bf16 tolerance, between two readings on this input (logits up to 0.67):
# the port in bf16 lies up to 0.0117 from the reference in bf16 (3 bf16 ulps
# at 0.5), and the port in f32 on the same parameters lies up to 0.0261 from
# it (the reference's own bf16-vs-f32 gap). So 0.02 holds the port to the
# reference's bf16 roundings, and the f32 control must fail it.
BF16 = dict(atol=0.02, rtol=0)


def test_bf16_activations_qwen3_smoke():
    """The qwen3 smoke config with bf16 activations (f32 parameters); the
    same port computing in f32 is a control that must fall outside."""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("qwen3-8b"), dtype=jnp.bfloat16)
    cfg = port_config(ref_cfg)
    tree = ref_params(ref_cfg, 0)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    want, _, _ = ref_model.forward(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(tokens, jnp.int32), ref_cfg)
    got, _, _ = port_model(cfg, tree)(torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    close(got, want, **BF16)
    control, _, _ = port_model(dataclasses.replace(cfg, dtype=torch.float32), tree)(
        torch.from_numpy(tokens))
    with pytest.raises(AssertionError):
        close(control, want, **BF16)


# --------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,z_loss", [("granite-3-2b", 1e-4), ("granite-3-2b", 0.0),
                                         ("qwen3-8b", 1e-4)])
def test_ce_loss(arch, z_loss):
    """``ce_loss`` on the same f32 logits and labels; granite's smoke vocab
    (515 padded to 768) checks the mask of the padded ids."""
    ref_cfg = ref_configs.get_smoke_config(arch)
    cfg = port_configs.get_smoke_config(arch)
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((2, 12, cfg.vocab_padded)) * 4).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 12))
    want = ref_model.ce_loss(jnp.asarray(logits), jnp.asarray(labels, jnp.int32), ref_cfg,
                             z_loss=z_loss)
    got = port_model_lib.ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), cfg,
                                 z_loss=z_loss)
    close(got, want, **F32)
    unmasked = port_model_lib.ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                      dataclasses.replace(cfg, vocab_size=cfg.vocab_padded),
                                      z_loss=z_loss)
    assert (cfg.vocab_padded == cfg.vocab_size) == bool(torch.isclose(unmasked, got))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-small"])
def test_loss_fn(arch):
    """``loss_fn``: the CE of the forward plus ``aux_weight`` times the MoE
    aux loss, with the cross-attention source for whisper."""
    ref_cfg = ref_configs.get_smoke_config(arch)
    cfg = port_configs.get_smoke_config(arch)
    tree = ref_params(ref_cfg, 0)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    labels = rng.integers(0, cfg.vocab_size, (2, 12))
    ex = extras_np(cfg, 2)
    want, want_parts = jax.jit(ref_model.loss_fn, static_argnums=2, static_argnames="aux_weight")(
        jax.tree.map(jnp.asarray, tree),
        {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32),
         "extras": to_jax(ex, ref_cfg)}, ref_cfg, aux_weight=0.5)
    got, got_parts = port_model_lib.loss_fn(
        port_model(cfg, tree), {"tokens": torch.from_numpy(tokens),
                                "labels": torch.from_numpy(labels), "extras": to_torch(ex, cfg)},
        aux_weight=0.5)
    close(got, want, **F32)
    close(got_parts["ce"], want_parts["ce"], **F32)
    close(got_parts["aux"], want_parts["aux"], **F32)
    assert (cfg.moe is not None) == (float(got_parts["aux"]) > 0)
