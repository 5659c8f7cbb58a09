"""The port's h-index ops and plain kernel versions against the JAX package.

On a CPU tensor each kernel wrapper runs its plain PyTorch version; these
tests hold those, and the torch ``hindex_sorted`` / ``hindex_count`` ops,
bit-identical to the JAX package's ops and to its Pallas kernels run in
interpret mode, over the shape, tiling and seeded-state sweeps of
``test_kernels_hindex.py`` and ``test_fused_engine.py``. All values are
integers, so every comparison is exact (tolerance 0).

The kernels skip chunks of candidates above the tile's current-estimate
maximum, which is exact only on states the engines reach (estimates are
monotone-decreasing upper bounds), so the inputs here satisfy
``cur >= ext + h`` as the reference tests' inputs do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hindex as ref_hindex
from repro.kernels.fused import fused_sweep_op as ref_fused_op
from repro.kernels.fused import fused_sweep_pallas as ref_fused_pallas
from repro.kernels.hindex import hindex_op as ref_hindex_op
from repro.kernels.hindex import hindex_pallas as ref_hindex_pallas
from repro_torch.core import hindex as port_hindex
from repro_torch.kernels.counts import partial_counts_op
from repro_torch.kernels.fused import fused_sweep_op, fused_sweep_plain
from repro_torch.kernels.hindex import hindex_op, hindex_plain
from test_torch_call_setup_cuda import DRAWS, draw

# The graphs here are small and pytest-xdist runs several workers side by
# side: one intra-op thread per worker keeps them from contending for cores.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# One compile per shape instead of one dispatch per jnp op per candidate chunk.
_ref_sorted = jax.jit(ref_hindex.hindex_sorted)
_ref_count = jax.jit(ref_hindex.hindex_count, static_argnames="cand_chunk")


# --------------------------------------------------------------------- #
# core.hindex ops
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,d", [(1, 1), (7, 5), (16, 8), (33, 64), (8, 300)])
@pytest.mark.parametrize("cand_chunk", [3, 256])
def test_hindex_ops_match_jnp(n, d, cand_chunk):
    rng = np.random.default_rng(n * 100 + d)
    x = rng.integers(-1, d + 4, size=(n, d)).astype(np.int32)
    ext = rng.integers(0, 6, size=n).astype(np.int32)
    want_s = np.asarray(_ref_sorted(x, ext))
    want_c = np.asarray(_ref_count(x, ext, cand_chunk=cand_chunk))
    got_s = port_hindex.hindex_sorted(_t(x), _t(ext))
    got_c = port_hindex.hindex_count(_t(x), _t(ext), cand_chunk=cand_chunk)
    assert got_s.dtype == got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    for r in range(n):
        assert got_s[r] == ref_hindex.hindex_brute(x[r], int(ext[r]))


def test_host_hindex_helpers_are_copies():
    rng = np.random.default_rng(3)
    for _ in range(20):
        v = rng.integers(0, 50, size=int(rng.integers(0, 40)))
        assert port_hindex.hindex_of_sequence(v) == ref_hindex.hindex_of_sequence(v)
        row = rng.integers(-1, 30, size=16).astype(np.int32)
        assert port_hindex.hindex_brute(row, 2) == ref_hindex.hindex_brute(row, 2)


@pytest.mark.parametrize("name", DRAWS)
def test_hindex_of_tensor_matches_the_host_hindex(name):
    """``decompose``'s set-up h-index, on a CPU tensor (on the card:
    ``test_torch_call_setup_cuda.py``)."""
    values = draw(name)
    got = port_hindex.hindex_of_tensor(torch.as_tensor(values, dtype=torch.int32))
    assert got.dim() == 0 and got.dtype == torch.int64
    assert int(got) == ref_hindex.hindex_of_sequence(values)
    if name.startswith("h_is_n"):
        assert int(got) == values.size


# --------------------------------------------------------------------- #
# h-index kernel: plain version vs hindex_op / hindex_pallas (interpret)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [8, 16, 64, 256])
@pytest.mark.parametrize("w", [8, 32, 128, 512])
def test_hindex_plain_shape_sweep(n, w):
    rng = np.random.default_rng(n * 1000 + w)
    x = rng.integers(-1, w, size=(n, w)).astype(np.int32)
    ext = rng.integers(0, 8, size=n).astype(np.int32)
    cur = (np.maximum(x, 0).sum(axis=1) % (w + 4)).astype(np.int32) + ext + w
    cand = min(w, 64)
    want = np.asarray(ref_hindex_op(jnp.asarray(x), jnp.asarray(ext),
                                    jnp.asarray(cur), cand=cand))
    got = hindex_op(_t(x), _t(ext), cand=cand)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(hindex_plain(_t(x), _t(ext), cand=cand).numpy(), want)


@pytest.mark.parametrize("tile_n", [8, 16, 32])
@pytest.mark.parametrize("cand_chunk", [16, 128])
def test_hindex_plain_tiling_sweep(tile_n, cand_chunk):
    rng = np.random.default_rng(tile_n + cand_chunk)
    n, w = 64, 64
    x = rng.integers(-1, 40, size=(n, w)).astype(np.int32)
    ext = rng.integers(0, 4, size=n).astype(np.int32)
    cur = np.full(n, w + 8, np.int32)
    want = np.asarray(ref_hindex_pallas(
        jnp.asarray(x), jnp.asarray(ext), jnp.asarray(cur),
        cand=w, tile_n=tile_n, cand_chunk=cand_chunk))
    np.testing.assert_array_equal(hindex_op(_t(x), _t(ext), cand=w).numpy(), want)


def test_hindex_plain_int16_inputs():
    rng = np.random.default_rng(5)
    x = rng.integers(-1, 30, size=(16, 32)).astype(np.int16)
    ext = np.zeros(16, np.int32)
    cur = np.full(16, 40, np.int32)
    want = np.asarray(ref_hindex_op(jnp.asarray(x), jnp.asarray(ext),
                                    jnp.asarray(cur), cand=32))
    got = hindex_op(_t(x), _t(ext), cand=32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_hindex_plain_candidate_window_and_brute(seed):
    """Degeneracy-bounded window == unbounded window on estimate rows, and
    both equal the paper's literal loop."""
    rng = np.random.default_rng(9 + seed)
    deg = rng.integers(1, 32, size=64)
    w = 32
    x = np.full((64, w), -1, dtype=np.int32)
    for r in range(64):
        x[r, : deg[r]] = rng.integers(0, deg[rng.integers(0, 64)] + 1, size=deg[r])
    ext = rng.integers(0, 4, size=64).astype(np.int32)
    u = max(1, ref_hindex.hindex_of_sequence(deg + ext))
    got = hindex_op(_t(x), _t(ext), cand=u).numpy()
    full = hindex_op(_t(x), _t(ext), cand=w).numpy()
    np.testing.assert_array_equal(got, full)
    want = np.asarray(ref_hindex_op(jnp.asarray(x), jnp.asarray(ext),
                                    jnp.asarray((deg + ext).astype(np.int32)), cand=u))
    np.testing.assert_array_equal(got, want)
    for r in range(64):
        assert full[r] == ref_hindex.hindex_brute(x[r], int(ext[r]))


# --------------------------------------------------------------------- #
# Fused kernel: plain version vs fused_sweep_op / fused_sweep_pallas
# --------------------------------------------------------------------- #
def _compare_fused(got, want, n):
    est, ch, dirty = got
    est_r, ch_r, dirty_r = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(est.numpy(), est_r)
    np.testing.assert_array_equal(ch.numpy(), ch_r)
    # Slot n collects the reference's pushes to pad neighbours, which no
    # reader looks at; the port never pushes there.
    np.testing.assert_array_equal(dirty.numpy()[:n], dirty_r[:n])
    assert int(dirty[n]) == 0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("track_dirty", [True, False])
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_fused_plain_seeded(seed, track_dirty, dtype):
    # Start from a valid upper-bound state, compare sweep 1, scatter, and
    # compare sweep 2 on the reached state (predication now active).
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 80))
    rows = int(rng.integers(1, 30))
    w = int(2 ** rng.integers(3, 7))
    ext = np.concatenate([rng.integers(0, 4, n), [0]]).astype(np.int32)
    c = np.concatenate([ext[:-1] + w + rng.integers(0, 5, n), [-1]]).astype(dtype)
    rows = min(rows, n)
    ids = rng.permutation(n)[:rows].astype(np.int32)
    ids[rng.random(rows) < 0.2] = n
    neigh = np.where(rng.random((rows, w)) < 0.3, n,
                     rng.integers(0, n, (rows, w))).astype(np.int32)
    cand = int(rng.integers(1, w + 10))
    for _sweep in range(2):
        want = ref_fused_op(jnp.asarray(c), jnp.asarray(ext), jnp.asarray(ids),
                            jnp.asarray(neigh), cand=cand, track_dirty=track_dirty)
        got = fused_sweep_op(_t(c), _t(ext), _t(ids), _t(neigh), cand=cand,
                             track_dirty=track_dirty)
        _compare_fused(got, want, n)
        c[ids] = got[0].numpy().astype(dtype)
        c[-1] = -1


@pytest.mark.parametrize("tile_n", [1, 4, 8, 32])
def test_fused_plain_vs_pallas_tiles(tile_n):
    rng = np.random.default_rng(tile_n)
    n, rows, w = 40, 16, 8
    c = np.concatenate([w + rng.integers(0, 5, n), [-1]]).astype(np.int32)
    ext = np.zeros(n + 1, np.int32)
    ids = rng.permutation(n)[:rows].astype(np.int32)
    neigh = rng.integers(0, n + 1, (rows, w)).astype(np.int32)
    pad = (-rows) % tile_n
    est, ch, dirty = ref_fused_pallas(
        jnp.asarray(c), jnp.asarray(ext),
        jnp.pad(jnp.asarray(ids), (0, pad), constant_values=n),
        jnp.pad(jnp.asarray(neigh), ((0, pad), (0, 0)), constant_values=n),
        cand=8, tile_n=tile_n)
    got = fused_sweep_plain(_t(c), _t(ext), _t(ids), _t(neigh), cand=8)
    _compare_fused(got, (np.asarray(est)[:rows, 0], np.asarray(ch)[:rows, 0],
                         np.asarray(dirty)), n)


def test_fused_plain_accumulates_into_a_given_dirty_buffer():
    rng = np.random.default_rng(11)
    n, w = 60, 16
    c = _t(np.concatenate([w + rng.integers(0, 5, n), [-1]]).astype(np.int32))
    ext = torch.zeros(n + 1, dtype=torch.int32)
    dirty = torch.zeros(n + 1, dtype=torch.int8)
    union = torch.zeros(n + 1, dtype=torch.int8)
    for lo in (0, 20):
        ids = torch.arange(lo, lo + 20, dtype=torch.int32)
        neigh = _t(rng.integers(0, n + 1, (20, w)).astype(np.int32))
        _, _, out = fused_sweep_op(c, ext, ids, neigh, cand=w, dirty=dirty)
        assert out is dirty
        union = torch.maximum(union, fused_sweep_plain(c, ext, ids, neigh, cand=w)[2])
    assert torch.equal(dirty, union)


def test_wrappers_reject_bad_input_and_count_no_cpu_launches():
    x = torch.zeros(4, 8, dtype=torch.int32)
    ext = torch.zeros(4, dtype=torch.int32)
    before = (hindex_op.launches, fused_sweep_op.launches)
    hindex_op(x, ext, cand=4)
    c = torch.full((9,), 2, dtype=torch.int32)
    fused_sweep_op(c, torch.zeros(9, dtype=torch.int32), torch.arange(4, dtype=torch.int32),
                   torch.full((4, 8), 8, dtype=torch.int32), cand=4)
    # The plain versions are not kernel launches.
    assert (hindex_op.launches, fused_sweep_op.launches) == before
    with pytest.raises(ValueError):
        hindex_op(x, torch.zeros(5, dtype=torch.int32), cand=4)
    with pytest.raises(TypeError):
        hindex_op(x.to(torch.int64), ext, cand=4)
    with pytest.raises(ValueError):
        fused_sweep_op(c, torch.zeros(8, dtype=torch.int32), torch.arange(4, dtype=torch.int32),
                       torch.full((4, 8), 8, dtype=torch.int32), cand=4)
    with pytest.raises(TypeError):
        fused_sweep_op(c.to(torch.int64), torch.zeros(9, dtype=torch.int32),
                       torch.arange(4, dtype=torch.int32),
                       torch.full((4, 8), 8, dtype=torch.int32), cand=4)


# Each wrapper's tensors, small and valid: (op, its tensors).
_WRAPPERS = {
    "fused_sweep_op": (fused_sweep_op, lambda: (
        torch.full((9,), 2, dtype=torch.int32), torch.zeros(9, dtype=torch.int32),
        torch.arange(4, dtype=torch.int32), torch.full((4, 8), 8, dtype=torch.int32))),
    "hindex_op": (hindex_op, lambda: (
        torch.zeros(4, 8, dtype=torch.int32), torch.zeros(4, dtype=torch.int32))),
    "partial_counts_op": (partial_counts_op, lambda: (
        torch.zeros(4, 8, dtype=torch.int32), torch.zeros(4, dtype=torch.int32))),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrappers_share_one_placement_rule(name):
    """All three wrappers place a call by ``kernels/plan.py::placement``: on
    the CPU the plain version runs; a CPU/meta mix raises; all on meta
    raises for the two h-index kernels and gives the counts kernel's shape.
    None of it is a launch."""
    op, make = _WRAPPERS[name]
    tensors = make()
    before = op.launches
    op(*tensors, cand=4)
    with pytest.raises(ValueError, match="device"):
        op(tensors[0].to("meta"), *tensors[1:], cand=4)
    on_meta = [t.to("meta") for t in tensors]
    if op is partial_counts_op:
        out = op(*on_meta, cand=4)
        assert (out.device.type, out.shape, out.dtype) == ("meta", (4, 4), torch.int32)
    else:
        with pytest.raises(ValueError, match="device"):
            op(*on_meta, cand=4)
    assert op.launches == before
