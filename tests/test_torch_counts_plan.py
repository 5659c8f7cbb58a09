"""The partial-counts kernel's launch plan, and its plain version on the
inputs of each of the kernel's paths, against the JAX package.

``counts_launch_plan`` is a pure function of a slot shard's shape, so its
rules are checked here on the CPU: every path fits the H100 (the kernel's
``__launch_bounds__``, 227 KB of shared memory a block, a portable cluster
of 8 blocks, a grid under 2^31 blocks), its grid covers every row, and the
plan agrees with what ``csrc/counts.cu`` checks before it launches. The
plain version is held exactly (integers, tolerance 0) against the JAX
package's ``partial_counts_ref`` and its Pallas kernel in interpret mode
on shapes that reach each path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.counts import partial_counts_op as ref_counts_op
from repro.kernels.counts import partial_counts_ref
from repro_torch.kernels.counts import partial_counts_op, partial_counts_plain
from repro_torch.kernels.plan import (COUNTS_PATHS, HIST_SCRATCH, MAX_BINS, SMS, STEP_BLOCK,
                                      WARP_ROWS, CountsPlan, counts_launch_plan)

torch.set_num_threads(1)

SMEM_PER_BLOCK = 232_448  # 227 KB: the most shared memory one H100 block may take
GRID = 2**31              # blocks of a one-dimensional grid: fewer than this
LAUNCH_BOUNDS = {"step": 256, "warp": 256, "hist": 1024}  # counts.cu __launch_bounds__
CANDS = [1, 2, 3, 1389, 8193, 60_000]
ROWS = [1, 3, 8, 24, 37, 192, 1144, 10_720, 385_720]
WIDTHS = [1 << k for k in range(17)] + [1, 3, 5, 17]

# rmat(20, 16, seed=0)'s 57 tiles by width class: (tiles, rows), cand 1389.
RMAT20_CLASSES = {
    8: (36, 385_720), 16: (6, 94_896), 32: (2, 30_880), 64: (4, 74_008),
    128: (1, 9_736), 256: (2, 29_128), 512: (1, 15_504), 2048: (1, 4_848),
    4096: (1, 1_144), 16384: (1, 192), 32768: (1, 24), 65536: (1, 8),
}


def _check_plan(plan: CountsPlan, rows: int, w: int, cand: int) -> None:
    assert plan.path in COUNTS_PATHS
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= LAUNCH_BOUNDS[plan.path]
    assert 0 < plan.smem_bytes <= SMEM_PER_BLOCK
    assert 1 <= plan.cluster <= 8 and plan.blocks % plan.cluster == 0
    assert 0 <= plan.blocks < GRID
    # The grid covers every row, with less than one block (or cluster) to spare.
    units = plan.blocks // plan.cluster
    assert units * plan.rows_per_block >= rows
    assert rows == 0 or (units - 1) * plan.rows_per_block < rows
    if plan.path == "step":  # what counts.cu checks before it launches
        group = 8 if w <= 8 else 16
        assert w <= 16 and plan.threads == STEP_BLOCK and plan.cluster == 1
        assert plan.rows_per_block % (STEP_BLOCK // group) == 0
        assert plan.smem_bytes >= plan.rows_per_block * group * 4
    elif plan.path == "warp":
        assert w <= 1024 and plan.threads == 32 * WARP_ROWS and plan.cluster == 1
        assert plan.rows_per_block == WARP_ROWS
        assert plan.smem_bytes >= WARP_ROWS * ((cand + 6) // 4 * 4) * 4
    else:
        assert plan.rows_per_block == 1 and plan.threads >= 256
        assert plan.smem_bytes == (min(cand, MAX_BINS) + HIST_SCRATCH) * 4


@pytest.mark.parametrize("w", WIDTHS)
def test_plan_fits_the_card_at_every_width(w):
    for rows in ROWS:
        for cand in CANDS:
            plan = counts_launch_plan(rows, w, cand)
            _check_plan(plan, rows, w, cand)
            warp_fits = WARP_ROWS * ((cand + 6) // 4 * 4) * 4 <= SMEM_PER_BLOCK
            want = "step" if w <= 16 else "warp" if w <= 1024 and warp_fits else "hist"
            assert plan.path == want, (rows, w, cand, plan)
            if plan.path == "hist" and rows < SMS and w >= 2048:
                assert plan.cluster > 1, plan  # a hub tile is split over a cluster
            if rows >= 10_000:
                assert plan.blocks >= SMS


def test_plan_grid_limit():
    assert counts_launch_plan(GRID - 1, 2048, 1389).blocks == GRID - 1
    with pytest.raises(ValueError, match="grid"):
        counts_launch_plan(GRID - 1, 2048, 1389, path="hist", cluster=2)


@pytest.mark.parametrize("shards", [1, 2])
def test_plan_at_rmat20_tiles(shards):
    for width, (tiles, rows) in RMAT20_CLASSES.items():
        per_tile = -(-rows // tiles)
        w = width // shards
        plan = counts_launch_plan(per_tile, w, 1389)
        _check_plan(plan, per_tile, w, 1389)
        assert plan.path == ("step" if w <= 16 else "warp" if w <= 1024 else "hist")
        # Tiles whose rows alone cannot fill the card split them over a cluster.
        assert plan.cluster == {32768: 8, 65536: 8}.get(width, 1), (width, plan)
        assert plan.blocks >= min(SMS, per_tile), (width, plan)


@pytest.mark.parametrize("w,path,cluster", [
    (8, "warp", None), (4, "hist", None), (8, "hist", 4), (16, "hist", 1),
    (100, "hist", 2), (1024, "hist", None), (1025, "hist", 8), (65536, "hist", 1),
])
def test_forced_plans_cover_their_shape(w, path, cluster):
    for rows in (1, 37, 1000):
        for cand in (1, 3, 1389):
            plan = counts_launch_plan(rows, w, cand, path=path, cluster=cluster)
            assert plan.path == path and plan.cluster == (cluster or plan.cluster)
            _check_plan(plan, rows, w, cand)


@pytest.mark.parametrize("w,cand,path,cluster", [
    (17, 1389, "step", None),          # the step path takes at most 16 slots
    (1025, 1389, "warp", None),        # the warp path at most 1,024
    (100, 60_000, "warp", None),       # eight warps' bins exceed shared memory
    (2048, 1389, "hist", 16),          # beyond a portable cluster
    (2048, 1389, "warp", 2),           # a cluster off the hist path
    (64, 1389, "block", None),         # no such path
    (8, 0, None, None),                # no candidate
])
def test_impossible_plans_raise(w, cand, path, cluster):
    with pytest.raises(ValueError):
        counts_launch_plan(10, w, cand, path=path, cluster=cluster)


def test_wrapper_rejects_a_plan_for_other_shapes():
    x = torch.full((4, 8), 5, dtype=torch.int32)
    ext = torch.zeros(4, dtype=torch.int32)
    want = partial_counts_plain(x, ext, cand=9)
    ok = counts_launch_plan(4, 8, 9, path="hist", cluster=2)
    got = partial_counts_op(x, ext, cand=9, plan=ok)  # forced but consistent
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for bad in (counts_launch_plan(400, 8, 9), counts_launch_plan(4, 8, 60_000, path="hist"),
                ok._replace(threads=512), ok._replace(smem_bytes=4),
                ok._replace(cluster=0), ok._replace(rows_per_block=2)):
        with pytest.raises(ValueError, match="launch plan"):
            partial_counts_op(x, ext, cand=9, plan=bad)


# --------------------------------------------------------------------- #
# The plain version vs the JAX package on each path's inputs
# --------------------------------------------------------------------- #
def _inputs(rng, rows, w, cand, kind):
    ext = rng.integers(0, 5, size=rows).astype(np.int32)
    if kind == "duplicates":  # a few distinct estimates: one bin takes most slots
        x = rng.choice(np.array([-1, 0, 1, 2, w // 2 + 1, cand + 7]), size=(rows, w))
    elif kind == "hub":        # every slot above the window
        x = np.full((rows, w), cand + 100)
    else:
        x = rng.integers(-1, min(cand, w) + 20, size=(rows, w))
    x = np.where(rng.random((rows, w)) < 0.2, -1, x).astype(np.int32)
    return x, ext


@pytest.mark.parametrize("rows,w,cand,kind,path", [
    (37, 8, 1389, "random", "step"),       # cand far above the width
    (33, 4, 1389, "duplicates", "step"),   # a half-width slot shard
    (5, 16, 3, "random", "step"),          # rows x cand = 15, not a multiple of 4
    (13, 5, 2, "duplicates", "step"),
    (40, 16, 7, "random", "step"),
    (1, 1, 1, "random", "step"),           # one row, one candidate
    (1, 16, 1389, "hub", "step"),
    (9, 64, 130, "random", "warp"),
    (3, 1024, 50, "duplicates", "warp"),
    (7, 33, 1, "random", "warp"),
    (2, 1000, 1389, "hub", "warp"),
    (3, 2048, 1389, "duplicates", "hist"),  # one block a row
    (2, 4096, 300, "random", "hist"),       # a cluster of 4 a row
])
def test_plain_matches_reference_on_path_inputs(rows, w, cand, kind, path):
    rng = np.random.default_rng(rows * 131 + w + cand)
    x, ext = _inputs(rng, rows, w, cand, kind)
    assert counts_launch_plan(rows, w, cand).path == path
    want = np.asarray(partial_counts_ref(jnp.asarray(x), jnp.asarray(ext), cand))
    kernel = np.asarray(ref_counts_op(jnp.asarray(x), jnp.asarray(ext), cand=cand))
    np.testing.assert_array_equal(kernel, want)
    xt, et = torch.from_numpy(x), torch.from_numpy(ext)
    for plan in {counts_launch_plan(rows, w, cand), counts_launch_plan(rows, w, cand, path="hist")}:
        got = partial_counts_op(xt, et, cand=cand, plan=plan)
        assert got.dtype == torch.int32 and got.shape == (rows, cand)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(partial_counts_plain(xt, et, cand=cand).numpy(), want)


@pytest.mark.parametrize("rows,w,cand", [
    (2, 100, 60_000),   # the warp path's bins do not fit: hist, two windows
    (3, 8, 8193),       # a step row far narrower than its window
])
def test_plain_matches_reference_on_large_windows(rows, w, cand):
    rng = np.random.default_rng(cand)
    x, ext = _inputs(rng, rows, w, cand, "random")
    x[:, : w // 2] = rng.integers(cand - 50, cand + 50, size=(rows, w // 2))
    want = np.asarray(partial_counts_ref(jnp.asarray(x), jnp.asarray(ext), cand))
    got = partial_counts_op(torch.from_numpy(x), torch.from_numpy(ext), cand=cand)
    np.testing.assert_array_equal(got.numpy(), want)
