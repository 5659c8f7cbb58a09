"""The port's partial-counts kernel wrapper and plain version against the
JAX package.

On CPU tensors ``partial_counts_op`` runs its plain version; both are held
bit-identical to the JAX package's ``partial_counts_op`` (the Pallas kernel
in interpret mode) and to its oracle ``partial_counts_ref``, over the shape
grid of ``test_kernels_counts.py`` and the edge cases the JAX glue pads
for (rows not a multiple of 8, ``cand`` above the width, all-pad rows).
The distributed engine's own path without the kernel (``_partial_counts``)
must equal the kernel path. All values are integers: every comparison is
exact (tolerance 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.counts import partial_counts_op as ref_counts_op
from repro.kernels.counts import partial_counts_ref
from repro_torch.core.distributed import _partial_counts
from repro_torch.kernels.counts import partial_counts_op, partial_counts_plain

torch.set_num_threads(1)


def _check(x, ext, cand):
    want = np.asarray(partial_counts_ref(jnp.asarray(x), jnp.asarray(ext), cand))
    kernel = np.asarray(ref_counts_op(jnp.asarray(x), jnp.asarray(ext), cand=cand))
    np.testing.assert_array_equal(kernel, want)
    xt, et = torch.from_numpy(x), torch.from_numpy(ext)
    got = partial_counts_op(xt, et, cand=cand)
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], cand)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(partial_counts_plain(xt, et, cand=cand).numpy(), want)


@pytest.mark.parametrize("n", [8, 40, 128])
@pytest.mark.parametrize("w", [8, 64, 600])
@pytest.mark.parametrize("cand", [4, 64, 130])
def test_counts_shape_sweep(n, w, cand):
    rng = np.random.default_rng(n * 7 + w + cand)
    x = rng.integers(-1, w + 4, size=(n, w)).astype(np.int32)
    ext = rng.integers(0, 6, size=n).astype(np.int32)
    _check(x, ext, cand)


@pytest.mark.parametrize("n,w,cand,all_pad", [
    (13, 24, 16, False),   # rows not a multiple of the JAX tile of 8
    (5, 4, 40, False),     # cand above the width
    (9, 16, 20, True),     # every slot a -1 pad
    (1, 1, 1, False),
])
def test_counts_edge_cases(n, w, cand, all_pad):
    rng = np.random.default_rng(n + w + cand)
    x = rng.integers(-1, w + 30, size=(n, w)).astype(np.int32)
    if all_pad:
        x[:] = -1
    ext = rng.integers(0, 5, size=n).astype(np.int32)
    _check(x, ext, cand)


def test_counts_plain_chunks_rows_and_candidates(monkeypatch):
    """The plain version's row and candidate chunking (forced small here)
    changes nothing."""
    import repro_torch.kernels.counts.ops as ops

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-1, 90, size=(37, 50)).astype(np.int32))
    ext = torch.from_numpy(rng.integers(0, 9, size=37).astype(np.int32))
    whole = partial_counts_plain(x, ext, cand=70)
    monkeypatch.setattr(ops, "_PLAIN_CHUNK", 50 * 3)
    np.testing.assert_array_equal(partial_counts_plain(x, ext, cand=70).numpy(), whole.numpy())


@pytest.mark.parametrize("cand,cand_chunk", [(16, 256), (300, 256), (40, 7)])
def test_engine_path_matches_kernel_path(cand, cand_chunk):
    rng = np.random.default_rng(cand)
    x = torch.from_numpy(rng.integers(-1, 320, size=(24, 32)).astype(np.int32))
    ext = torch.from_numpy(rng.integers(0, 4, size=24).astype(np.int32))
    engine = _partial_counts(x, ext, cand, cand_chunk=cand_chunk)
    np.testing.assert_array_equal(engine.numpy(), partial_counts_op(x, ext, cand=cand).numpy())


def test_counts_wrapper_rejects_bad_input_and_counts_no_cpu_launches():
    x = torch.zeros(4, 8, dtype=torch.int32)
    ext = torch.zeros(4, dtype=torch.int32)
    before = partial_counts_op.launches
    partial_counts_op(x, ext, cand=3)
    assert partial_counts_op.launches == before  # the CPU runs the plain version
    with pytest.raises(ValueError, match="rows"):
        partial_counts_op(x, ext[:3], cand=3)
    with pytest.raises(ValueError, match="cand"):
        partial_counts_op(x, ext, cand=0)
    with pytest.raises(TypeError):
        partial_counts_op(x.to(torch.int64), ext, cand=3)
    assert partial_counts_op(x[:0], ext[:0], cand=5).shape == (0, 5)
