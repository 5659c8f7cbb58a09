"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every comparison is exact (all values are integers). The kernels have no
CPU mode, so these tests need an NVIDIA GPU with ``nvcc`` and skip
elsewhere; the plain versions are pinned against the JAX package on the
CPU in ``test_torch_kernels.py``. Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.decompose import decompose
from repro_torch.graph.build import bucketize
from repro_torch.graph.generators import rmat
from repro_torch.graph.oracle import peel_coreness
from repro_torch.core.distributed import MeshPlan, decompose_distributed
from repro_torch.kernels.counts import partial_counts_op, partial_counts_plain
from repro_torch.kernels.fused import fused_sweep_op, fused_sweep_plain
from repro_torch.kernels.hindex import hindex_op, hindex_plain
from repro_torch.kernels.plan import MAX_BINS, counts_launch_plan, fused_launch_plan

pytestmark = pytest.mark.cuda

# Every width class: a sub-warp group per row (<= 16), a warp per row
# (<= 1024, each register-count instantiation), a histogram per row (a
# cluster of blocks on tiles of few rows); odd widths too.
WIDTHS = [1, 5, 8, 16, 17, 32, 33, 64, 100, 256, 512, 1000, 1024, 1025,
          2048, 8192, 65536]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows_for(w):
    return max(3, min(300, (1 << 16) // w))


@pytest.mark.parametrize("w", WIDTHS)
def test_hindex_kernel_vs_plain(dev, w):
    rng = np.random.default_rng(w)
    rows = _rows_for(w)
    x = rng.integers(-1, w + 6, size=(rows, w)).astype(np.int32)
    ext = rng.integers(0, 8, size=rows).astype(np.int32)
    for cand in sorted({1, 7, min(w, 64), w, 1389, w + 10}):
        xt, et = torch.from_numpy(x).to(dev), torch.from_numpy(ext).to(dev)
        got = hindex_op(xt, et, cand=cand)
        want = hindex_plain(xt, et, cand=cand)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (w, cand)


def _valid_state(rng, n, w, ext):
    # Estimates that are upper bounds the engines can reach (>= ext + any
    # h-index over a width-w row).
    return np.concatenate([ext[:-1] + w + rng.integers(0, 5, n), [-1]])


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("track_dirty", [True, False])
def test_fused_kernel_vs_plain(dev, w, dtype, track_dirty):
    rng = np.random.default_rng(w + (dtype == torch.int16))
    n = 3 * w + 50
    rows = min(_rows_for(w), n)
    ext = np.concatenate([rng.integers(0, 4, n), [0]]).astype(np.int32)
    c = torch.from_numpy(_valid_state(rng, n, w, ext)).to(dtype).to(dev)
    ext_t = torch.from_numpy(ext).to(dev)
    ids_np = rng.permutation(n)[:rows].astype(np.int32)
    ids_np[rng.random(rows) < 0.2] = n  # sentinel pad rows
    ids = torch.from_numpy(ids_np).to(dev)
    neigh = torch.from_numpy(np.where(
        rng.random((rows, w)) < 0.3, n, rng.integers(0, n, (rows, w))
    ).astype(np.int32)).to(dev)
    cand = int(rng.integers(1, w + 10))
    for _sweep in range(3):
        got = fused_sweep_op(c, ext_t, ids, neigh, cand=cand, track_dirty=track_dirty)
        want = fused_sweep_plain(c, ext_t, ids, neigh, cand=cand, track_dirty=track_dirty)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (w, dtype, track_dirty, _sweep)
        c[ids.long()] = got[0].to(dtype)
        c[-1] = -1


def test_fused_dirty_buffer_accumulates(dev):
    rng = np.random.default_rng(0)
    n, w, rows = 200, 8, 64
    ext = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    c = torch.from_numpy(_valid_state(rng, n, w, ext.cpu().numpy())).to(torch.int32).to(dev)
    dirty = torch.zeros(n + 1, dtype=torch.int8, device=dev)
    ref = torch.zeros(n + 1, dtype=torch.int8, device=dev)
    for part in range(2):
        ids = torch.arange(part * rows, (part + 1) * rows, dtype=torch.int32, device=dev)
        neigh = torch.from_numpy(rng.integers(0, n + 1, (rows, w)).astype(np.int32)).to(dev)
        _, _, out = fused_sweep_op(c, ext, ids, neigh, cand=w, dirty=dirty)
        assert out is dirty
        fused_sweep_plain(c, ext, ids, neigh, cand=w, dirty=ref)
    torch.cuda.synchronize()
    assert torch.equal(dirty, ref)
    assert int(dirty[-1]) == 0  # the sentinel slot is never pushed


def _fused_inputs(rng, dev, rows, w, dtype, hub=False):
    """A valid state (estimates >= ext + any h-index of a width-w row) and a
    [rows, w] bucket over n nodes; ``hub`` points every real slot at one
    node, so every slot of a row lands in one histogram bin and every push
    of the launch on one dirty byte."""
    n = max(3 * w + 50, rows + 1)
    ext = np.concatenate([rng.integers(0, 4, n), [0]]).astype(np.int32)
    c = torch.from_numpy(_valid_state(rng, n, w, ext)).to(dtype).to(dev)
    ids_np = rng.permutation(n)[:rows].astype(np.int32)
    ids_np[rng.random(rows) < 0.1] = n  # sentinel pad rows
    targets = np.full((rows, w), 7) if hub else rng.integers(0, n, (rows, w))
    neigh = np.where(rng.random((rows, w)) < 0.2, n, targets).astype(np.int32)
    return (c, torch.from_numpy(ext).to(dev), torch.from_numpy(ids_np).to(dev),
            torch.from_numpy(neigh).to(dev))


def _check_fused_sweeps(c, ext, ids, neigh, cand, track_dirty, plan=None, sweeps=2):
    """Kernel == plain version, exactly, over a few sweeps of one bucket
    (the state the engine would reach after each)."""
    for sweep in range(sweeps):
        got = fused_sweep_op(c, ext, ids, neigh, cand=cand, track_dirty=track_dirty, plan=plan)
        want = fused_sweep_plain(c, ext, ids, neigh, cand=cand, track_dirty=track_dirty)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (neigh.shape, cand, track_dirty, plan, sweep)
        c[ids.long()] = got[0].to(c.dtype)
        c[-1] = -1


# The sub-warp path (8 or 16 lanes a row, 16 or 8 rows a block): row counts
# that leave a ragged last block and a ragged last warp.
@pytest.mark.parametrize("w", [1, 5, 8, 16])
@pytest.mark.parametrize("rows", [1, 37, 1001])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("track_dirty", [True, False])
def test_fused_group_path(dev, w, rows, dtype, track_dirty):
    rng = np.random.default_rng(w * 10_000 + rows)
    c, ext, ids, neigh = _fused_inputs(rng, dev, rows, w, dtype)
    assert fused_launch_plan(rows, w, w).path == "group"
    for cand in (1, 3, w, 1389):
        _check_fused_sweeps(c.clone(), ext, ids, neigh, cand, track_dirty)


# Hub widths with few rows: each row split over a thread-block cluster.
@pytest.mark.parametrize("w", [16384, 32768, 65536])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("track_dirty", [True, False])
def test_fused_cluster_split(dev, w, rows, dtype, track_dirty):
    rng = np.random.default_rng(w + rows)
    c, ext, ids, neigh = _fused_inputs(rng, dev, rows, w, dtype)
    plan = fused_launch_plan(rows, w, 1389)
    assert plan.path == "hist" and plan.cluster == 8
    _check_fused_sweeps(c, ext, ids, neigh, 1389, track_dirty)


@pytest.mark.parametrize("cand,path", [
    (MAX_BINS - 1, "hist"),    # the most bins shared memory holds: 224 KB a block
    (MAX_BINS, "search"),      # one bin more: the exact search path
    (65536, "search"),
])
def test_fused_bin_cap(dev, cand, path):
    rng = np.random.default_rng(cand)
    # Estimates are ext + 65536 + a few, so the bins up to the cap are reached.
    c, ext, ids, neigh = _fused_inputs(rng, dev, 3, 65536, torch.int32)
    assert fused_launch_plan(3, 65536, cand).path == path
    _check_fused_sweeps(c, ext, ids, neigh, cand, True)


# Every path and cluster forced onto widths it covers, down to a few slots
# a block.
@pytest.mark.parametrize("w,path,cluster", [
    (8, "warp", None), (8, "hist", 1), (8, "hist", 4), (16, "search", None),
    (100, "hist", 1), (100, "hist", 2), (1000, "search", None), (1025, "hist", 8),
    (2048, "search", None), (4096, "hist", 1), (16384, "hist", 1), (65536, "hist", 1),
])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_fused_forced_plans(dev, w, path, cluster, dtype):
    rng = np.random.default_rng(w)
    rows = min(_rows_for(w), 64)
    c, ext, ids, neigh = _fused_inputs(rng, dev, rows, w, dtype)
    for cand in (1, min(w, 40), 1389):
        plan = fused_launch_plan(rows, w, cand, path=path, cluster=cluster)
        _check_fused_sweeps(c.clone(), ext, ids, neigh, cand, True, plan=plan)


# Every neighbour one node: one histogram bin takes every slot of a row,
# and every push of the launch hits one byte.
@pytest.mark.parametrize("w", [8, 16, 64, 1024, 4096, 65536])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("track_dirty", [True, False])
def test_fused_one_hub_neighbour(dev, w, dtype, track_dirty):
    rng = np.random.default_rng(w + 1)
    rows = min(_rows_for(w) * 4, 1000)
    c, ext, ids, neigh = _fused_inputs(rng, dev, rows, w, dtype, hub=True)
    for cand in (1, min(w, 1389)):
        _check_fused_sweeps(c.clone(), ext, ids, neigh, cand, track_dirty)


def test_fused_dirty_buffer_shared_across_paths(dev):
    # One buffer for launches of every path, as a sweep passes it to all its
    # buckets: a byte set by one launch is tested (and not stored) by the next.
    rng = np.random.default_rng(1)
    n = 40_000
    ext = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    c = torch.from_numpy(_valid_state(rng, n, 65536, ext.cpu().numpy())).to(torch.int32).to(dev)
    dirty = torch.zeros(n + 1, dtype=torch.int8, device=dev)
    ref = torch.zeros(n + 1, dtype=torch.int8, device=dev)
    paths = set()
    for rows, w in [(300, 8), (100, 16), (64, 256), (20, 2048), (3, 32768), (2, 65536)]:
        ids = torch.from_numpy(rng.permutation(n)[:rows].astype(np.int32)).to(dev)
        neigh = torch.from_numpy(rng.integers(0, n + 1, (rows, w)).astype(np.int32)).to(dev)
        _, _, out = fused_sweep_op(c, ext, ids, neigh, cand=1389, dirty=dirty)
        assert out is dirty
        fused_sweep_plain(c, ext, ids, neigh, cand=1389, dirty=ref)
        paths.add(fused_launch_plan(rows, w, 1389).path)
    torch.cuda.synchronize()
    assert paths == {"group", "warp", "hist"}
    assert torch.equal(dirty, ref)
    assert int(dirty[-1]) == 0


def test_wrappers_count_launches_and_reject_bad_input(dev):
    x = torch.full((4, 8), 3, dtype=torch.int32, device=dev)
    ext = torch.zeros(4, dtype=torch.int32, device=dev)
    before = hindex_op.launches
    hindex_op(x, ext, cand=8)
    assert hindex_op.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        hindex_op(x.t().contiguous().t(), ext, cand=8)
    with pytest.raises(ValueError, match="device"):
        hindex_op(x, ext.cpu(), cand=8)
    with pytest.raises(TypeError):
        hindex_op(x.to(torch.int64), ext, cand=8)
    c = torch.full((11,), 5, dtype=torch.int32, device=dev)
    c[-1] = -1
    ext_pad = torch.zeros(11, dtype=torch.int32, device=dev)
    ids = torch.arange(4, dtype=torch.int32, device=dev)
    neigh = torch.full((4, 8), 10, dtype=torch.int32, device=dev)
    before = fused_sweep_op.launches
    fused_sweep_op(c, ext_pad, ids, neigh, cand=8)
    assert fused_sweep_op.launches == before + 1
    with pytest.raises(TypeError):
        fused_sweep_op(c.to(torch.int64), ext_pad, ids, neigh, cand=8)
    with pytest.raises(ValueError, match="launch plan"):
        fused_sweep_op(c, ext_pad, ids, neigh, cand=8,
                       plan=fused_launch_plan(4, 8, 8)._replace(blocks=2))
    assert fused_sweep_op.launches == before + 1


@pytest.mark.parametrize("op,int16", [("kernel", False), ("fused", False), ("fused", True)])
def test_decompose_on_card_matches_cpu(dev, op, int16):
    g = rmat(11, 8, seed=7)
    bg = bucketize(g)
    launches = (hindex_op if op == "kernel" else fused_sweep_op)
    before = launches.launches
    on_card = decompose(bg, op=op, int16=int16, device="cuda")
    assert launches.launches > before
    on_cpu = decompose(bg, op=op, int16=int16, device="cpu")
    np.testing.assert_array_equal(on_card.coreness, peel_coreness(g))
    np.testing.assert_array_equal(on_card.coreness, on_cpu.coreness)
    assert on_card.comm_per_iter == on_cpu.comm_per_iter
    assert on_card.active_rows_per_iter == on_cpu.active_rows_per_iter


@pytest.mark.parametrize("rows,w,cand,fill", [
    (0, 8, 16, None),          # no rows: no launch
    (37, 8, 1, None),          # one candidate
    (300, 4, 1389, None),      # cand far above the width (half-width shard)
    (8, 65536, 1389, None),    # hub rows, one block each
    (5, 300, 20000, None),     # cand above one shared-memory window
    (64, 33, 100, -1),         # every slot a pad
    (64, 33, 100, "ext"),      # ext above every slot
    (1000, 17, 64, None),
])
def test_counts_kernel_vs_plain(dev, rows, w, cand, fill):
    rng = np.random.default_rng(rows + w + cand)
    x = rng.integers(-1, w + 40, size=(rows, w)).astype(np.int32)
    ext = rng.integers(0, 8, size=rows).astype(np.int32)
    if fill == -1:
        x[:] = -1
    elif fill == "ext":
        ext[:] = 1_000_000_000  # above every slot; ext + cand stays in int32
    xt, et = torch.from_numpy(x).to(dev), torch.from_numpy(ext).to(dev)
    before = partial_counts_op.launches
    got = partial_counts_op(xt, et, cand=cand)
    want = partial_counts_plain(xt, et, cand=cand)
    torch.cuda.synchronize()
    assert got.shape == (rows, cand)
    assert torch.equal(got, want), (rows, w, cand, fill)
    assert partial_counts_op.launches == before + (rows > 0)


def test_counts_wrapper_rejects_bad_input(dev):
    x = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    ext = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        partial_counts_op(x.t().contiguous().t(), ext, cand=8)
    with pytest.raises(ValueError, match="device"):
        partial_counts_op(x, ext.cpu(), cand=8)
    with pytest.raises(TypeError):
        partial_counts_op(x.to(torch.int16), ext, cand=8)


@pytest.mark.parametrize("use_kernel,wire", [(True, torch.int32), (False, torch.int32),
                                             (True, torch.int16)])
def test_distributed_on_card_matches_cpu(dev, use_kernel, wire):
    g = rmat(11, 8, seed=7)
    bg = bucketize(g)
    before = partial_counts_op.launches
    on_card = decompose_distributed(bg, MeshPlan(), use_kernel=use_kernel,
                                    wire_dtype=wire, device="cuda")
    assert (partial_counts_op.launches > before) == use_kernel
    on_cpu = decompose_distributed(bg, MeshPlan(), use_kernel=use_kernel,
                                   wire_dtype=wire, device="cpu")
    np.testing.assert_array_equal(on_card.coreness, peel_coreness(g))
    np.testing.assert_array_equal(on_card.coreness, on_cpu.coreness)
    assert on_card.comm_per_iter == on_cpu.comm_per_iter
    assert on_card.active_rows_per_iter == on_cpu.active_rows_per_iter


# --------------------------------------------------------------------- #
# The h-index kernel on every path of the fused kernel's launch plan
# --------------------------------------------------------------------- #
def _hindex_plans(rows, w, cand):
    """The planned launch and each other path that covers the width (the
    hist path with one block a row and with a cluster of 8)."""
    plans = [fused_launch_plan(rows, w, cand)]
    for path, cluster in (("group", None), ("warp", None), ("hist", 1), ("hist", 8),
                          ("search", None)):
        try:
            plans.append(fused_launch_plan(rows, w, cand, path=path, cluster=cluster))
        except ValueError:
            pass
    return list(dict.fromkeys(plans))


@pytest.mark.parametrize("w", [1, 5, 8, 16, 4096, 16384, 65536])
@pytest.mark.parametrize("rows", [1, 3, 37, 1001])
def test_hindex_every_path(dev, w, rows):
    rng = np.random.default_rng(w * 7 + rows)
    x = rng.integers(-1, min(w, 1389) + 6, size=(rows, w))
    x[: rows // 2, : max(1, w // 3)] = 2  # one repeated estimate: one bin takes many slots
    x = np.where(rng.random((rows, w)) < 0.2, -1, x).astype(np.int32)
    xt = torch.from_numpy(x).to(dev)
    et = torch.from_numpy(rng.integers(0, 4, size=rows).astype(np.int32)).to(dev)
    paths = set()
    for cand in (3, 1389):
        want = hindex_plain(xt, et, cand=cand)
        for plan in _hindex_plans(rows, w, cand):
            got = hindex_op(xt, et, cand=cand, plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (w, rows, cand, plan)
            paths.add(plan.path)
    assert paths == ({"group", "warp", "hist", "search"} if w <= 16 else {"hist", "search"})


# --------------------------------------------------------------------- #
# The counts kernel on every path of its launch plan
# --------------------------------------------------------------------- #
def _counts_plans(rows, w, cand):
    """The planned launch and each other path that covers the shape (the
    hist path with one block a row and with a cluster of 8)."""
    plans = [counts_launch_plan(rows, w, cand)]
    for path, cluster in (("step", None), ("warp", None), ("hist", 1), ("hist", 8)):
        try:
            plans.append(counts_launch_plan(rows, w, cand, path=path, cluster=cluster))
        except ValueError:
            pass
    return list(dict.fromkeys(plans))


@pytest.mark.parametrize("rows,w,cand", [
    (1, 1, 1), (3, 5, 2), (37, 8, 3),   # rows x cand not a multiple of 4: flat head and tail
    (37, 8, 1389), (1001, 4, 1389),     # cand far above the width
    (1001, 16, 7), (64, 16, 1), (255, 16, 1389),
    (5, 33, 1), (37, 64, 130), (1001, 100, 1389), (3, 1024, 50),
    (8, 2048, 1389), (3, 4096, 300), (2, 65536, 1389),
    (5, 300, 20_000), (2, 100, 60_000), (1, 8, 60_000),  # window by window on the hist path
])
def test_counts_every_path(dev, rows, w, cand):
    rng = np.random.default_rng(rows * 31 + w + cand)
    x = rng.integers(-1, min(w, cand) + 20, size=(rows, w))
    x[: rows // 2, : max(1, w // 3)] = rng.choice([2, cand + 5])  # repeated estimates
    x = np.where(rng.random((rows, w)) < 0.2, -1, x).astype(np.int32)
    xt = torch.from_numpy(x).to(dev)
    et = torch.from_numpy(rng.integers(0, 6, size=rows).astype(np.int32)).to(dev)
    want = partial_counts_plain(xt, et, cand=cand)
    plans = _counts_plans(rows, w, cand)
    for plan in plans:
        before = partial_counts_op.launches
        got = partial_counts_op(xt, et, cand=cand, plan=plan)
        torch.cuda.synchronize()
        assert partial_counts_op.launches == before + 1
        assert got.shape == (rows, cand)
        assert torch.equal(got, want), (rows, w, cand, plan)
    assert "hist" in {p.path for p in plans}


# A tile whose rows x cand passes 2^31 outputs: every flat index is 64-bit.
@pytest.mark.parametrize("path", ["step", "warp", "hist"])
def test_counts_tile_past_2_31_outputs(dev, path):
    rows, w, cand = 1_600_000, 8, 1389
    assert rows * cand > 2**31
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-1, 1500, (rows, w), dtype=torch.int32, device=dev, generator=gen)
    ext = torch.randint(0, 5, (rows,), dtype=torch.int32, device=dev, generator=gen)
    got = partial_counts_op(x, ext, cand=cand, plan=counts_launch_plan(rows, w, cand, path=path))
    torch.cuda.synchronize()
    for sl in (slice(0, 1000), slice(rows - 1000, rows)):
        assert torch.equal(got[sl], partial_counts_plain(x[sl], ext[sl], cand=cand)), (path, sl)
