"""The call set-up of ``decompose`` on the card.

The device h-index (:func:`repro_torch.core.hindex.hindex_of_tensor`) on the
card against the port's host ``hindex_of_sequence`` (held bit-identical to
the JAX package's by ``tests/test_torch_kernels.py``), and a call on the
card against the same call on the CPU where the largest ``deg + ext`` is
``2**15 - 1`` and ``2**15``. Marked ``cuda`` (skip without a GPU); this file
imports no JAX, so the GPU host runs it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_call_setup_cuda.py

``draw`` and ``DRAWS`` are also the CPU cases of
``tests/test_torch_kernels.py``, which hold the device h-index against the
JAX package's.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core.decompose import decompose
from repro_torch.core.hindex import hindex_of_sequence, hindex_of_tensor
from repro_torch.graph import bucketize, rmat


def draw(name):
    """Start values of one case, int64 on the host."""
    rng = np.random.default_rng(2024)
    if name == "empty":
        return np.zeros(0, np.int64)
    if name == "zeros":
        return np.zeros(1000, np.int64)
    if name == "single":
        return np.array([7], np.int64)
    if name == "single_zero":
        return np.array([0], np.int64)
    if name == "above_n":  # three values far above n, the rest zero
        return np.array([10**6, 2**31 - 1, 40] + [0] * 10, np.int64)
    if name == "ext":  # deg + ext with most of ext > 0
        deg = rng.poisson(6.0, size=3000)
        ext = rng.integers(0, 50, size=3000) * (rng.random(3000) < 0.8)
        return deg + ext
    if name == "power_law":
        return np.minimum(rng.zipf(2.0, size=100_000), 2**31 - 1)
    if name == "uniform":
        return rng.integers(0, 64, size=50_000)
    if name == "h_is_n":  # every value at least n: h = n
        return np.arange(257, 514, dtype=np.int64)
    if name == "h_is_n_exact":  # n values all equal to n
        return np.full(100, 100, np.int64)
    if name == "h_below_n_by_one":
        return np.full(101, 100, np.int64)
    raise KeyError(name)


DRAWS = ["empty", "zeros", "single", "single_zero", "above_n", "ext",
         "power_law", "uniform", "h_is_n", "h_is_n_exact", "h_below_n_by_one"]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the set-up runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", DRAWS)
def test_hindex_of_tensor_on_the_card(dev, name):
    values = draw(name)
    got = hindex_of_tensor(torch.as_tensor(values, dtype=torch.int32, device=dev))
    assert got.dim() == 0 and got.dtype == torch.int64 and got.device.type == "cuda"
    assert int(got) == hindex_of_sequence(values)


@functools.lru_cache(maxsize=None)
def _part(max_start):
    g = rmat(9, 8, seed=7)
    deg = np.diff(g.indptr).astype(np.int64)
    ext = (np.arange(g.n_nodes) % 5).astype(np.int32)
    top = int(np.argmax(deg))
    ext[top] = max_start - deg[top]
    return bucketize(g, ext=ext)


@pytest.mark.cuda
@pytest.mark.parametrize("max_start", [(1 << 15) - 1, 1 << 15])
def test_decompose_guard_and_window_on_the_card(dev, max_start):
    bg = _part(max_start)
    card = decompose(bg, op="fused", int16=True, device=dev)
    cpu = decompose(bg, op="fused", int16=True, device="cpu")
    assert card.est_dtype == cpu.est_dtype == ("int16" if max_start < (1 << 15) else "int32")
    np.testing.assert_array_equal(card.coreness, cpu.coreness)
    assert card.iterations == cpu.iterations
    assert card.sweep_bytes_per_iter == cpu.sweep_bytes_per_iter
