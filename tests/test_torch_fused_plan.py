"""The fused kernel's launch plan, and its plain version on the inputs of the
kernel's new paths, against the JAX package.

``fused_launch_plan`` is a pure function of a bucket's shape, so its rules
are checked here on the CPU: every path fits the H100's shared memory
(227 KB a block) and a portable cluster (8 blocks), its grid covers every
row, and a large tile reaches every SM. The plain version is held exactly
(integers, tolerance 0) against the JAX reference ``fused_sweep_ref`` on
hub-width rows, rows of a few repeated estimates, one hub neighbour, and a
candidate window far above the width -- the inputs the kernel's histogram,
cluster and sub-warp paths are built for.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused.ref import fused_sweep_ref
from repro_torch.graph.build import bucketize
from repro_torch.graph.generators import rmat
from repro_torch.kernels.fused import fused_sweep_op
from repro_torch.kernels.plan import MAX_BINS, PATHS, SMS, FusedPlan, fused_launch_plan

torch.set_num_threads(1)

SMEM_PER_BLOCK = 232_448  # 227 KB: the most shared memory one H100 block may take
CANDS = [1, 7, 1389, MAX_BINS - 1, MAX_BINS, 10**6]
ROWS = [1, 3, 8, 24, 192, 1144, 4848, 10_000, 10_720, 385_720]

# rmat(20, 16, seed=0)'s 57 tiles by width class: (tiles, rows), cand 1389.
RMAT20_CLASSES = {
    8: (36, 385_720), 16: (6, 94_896), 32: (2, 30_880), 64: (4, 74_008),
    128: (1, 9_736), 256: (2, 29_128), 512: (1, 15_504), 2048: (1, 4_848),
    4096: (1, 1_144), 16384: (1, 192), 32768: (1, 24), 65536: (1, 8),
}


def _check_plan(plan: FusedPlan, rows: int, width: int, cand: int) -> None:
    bound = min(max(cand, 1), width)
    assert plan.path in PATHS
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert 1 <= plan.cluster <= 8 and plan.blocks % plan.cluster == 0
    rows_per_block = plan.threads // plan.group
    assert plan.threads % plan.group == 0
    # The grid covers every row, with less than one block to spare.
    assert (plan.blocks // plan.cluster) * rows_per_block >= rows
    assert (plan.blocks // plan.cluster - 1) * rows_per_block < rows
    if plan.path == "group":
        assert width <= plan.group <= 16 and plan.group in (8, 16)
    elif plan.path == "warp":
        assert width <= 1024 and plan.group == 32
    elif plan.path == "hist":
        assert plan.smem_bytes >= (bound + 1) * 4
        assert bound + 1 <= MAX_BINS
    else:  # the exact search: one block a row, any width
        assert plan.group == plan.threads == 1024 and plan.smem_bytes == 0
    if rows >= 10_000:
        assert plan.blocks >= SMS


@pytest.mark.parametrize("width", [1 << k for k in range(17)] + [5, 17, 100, 1025, 40_000])
def test_plan_fits_the_card_at_every_width(width):
    for rows in ROWS:
        for cand in CANDS:
            plan = fused_launch_plan(rows, width, cand)
            _check_plan(plan, rows, width, cand)
            want = ("group" if width <= 16 else "warp" if width <= 1024
                    else "hist" if min(cand, width) + 1 <= MAX_BINS else "search")
            assert plan.path == want, (rows, width, cand, plan)


def test_plan_at_rmat20_tiles():
    for width, (tiles, rows) in RMAT20_CLASSES.items():
        per_tile = -(-rows // tiles)
        plan = fused_launch_plan(per_tile, width, 1389)
        _check_plan(plan, per_tile, width, 1389)
        # Tiles whose rows alone cannot fill the card split them over a cluster.
        assert plan.cluster == {32768: 8, 65536: 8}.get(width, 1), (width, plan)
        assert plan.blocks >= min(SMS, per_tile), (width, plan)


@pytest.mark.parametrize("scale,edge_factor", [(12, 8), (14, 16)])
def test_plan_at_bucketized_tiles(scale, edge_factor):
    g = rmat(scale, edge_factor, seed=0)
    bg = bucketize(g)
    cand = int(max(bg.degrees))
    for b in bg.buckets:
        for c in (cand, 1389):
            _check_plan(fused_launch_plan(b.n_rows, b.width, c), b.n_rows, b.width, c)


@pytest.mark.parametrize("width,path,cluster", [
    (8, "warp", None), (8, "hist", 4), (16, "search", None), (100, "hist", 2),
    (1025, "hist", 8), (2048, "search", None), (65536, "hist", 1),
])
def test_forced_plans_cover_their_width(width, path, cluster):
    for rows in (1, 37, 1000):
        plan = fused_launch_plan(rows, width, 1389, path=path, cluster=cluster)
        assert plan.path == path and plan.cluster == (cluster or 1)
        _check_plan(plan, rows, width, 1389)


@pytest.mark.parametrize("width,path,cluster", [
    (17, "group", None),                # the group path takes at most 16 slots
    (1025, "warp", None),               # the warp path at most 1,024
    (65536, "hist", None),              # with cand 10**6 the bins exceed shared memory
    (2048, "hist", 16),                 # beyond a portable cluster
    (2048, "warp", 2),                  # a cluster off the hist path
    (64, "block", None),                # no such path
])
def test_impossible_plans_raise(width, path, cluster):
    with pytest.raises(ValueError):
        fused_launch_plan(10, width, 10**6, path=path, cluster=cluster)


def test_wrapper_rejects_a_plan_for_other_shapes():
    c = torch.full((11,), 5, dtype=torch.int32)
    c[-1] = -1
    ext = torch.zeros(11, dtype=torch.int32)
    ids = torch.arange(4, dtype=torch.int32)
    neigh = torch.full((4, 8), 10, dtype=torch.int32)
    ok = fused_launch_plan(4, 8, 8, path="hist", cluster=2)
    fused_sweep_op(c, ext, ids, neigh, cand=8, plan=ok)  # forced but consistent
    for bad in (fused_launch_plan(400, 8, 8), ok._replace(threads=512),
                ok._replace(smem_bytes=4), ok._replace(cluster=0)):
        with pytest.raises(ValueError):
            fused_sweep_op(c, ext, ids, neigh, cand=8, plan=bad)


# --------------------------------------------------------------------- #
# The plain version vs the JAX reference on the new paths' inputs
# --------------------------------------------------------------------- #
def _inputs(rng, rows, w, kind):
    n = max(3 * w + 50, rows + 1)
    ext = np.concatenate([rng.integers(0, 4, n), [0]]).astype(np.int32)
    if kind == "duplicates":  # a few distinct estimates: one bin takes most slots
        base = rng.choice(np.array([1, 2, 3, w // 2 + 1, w + 5]), size=n)
    else:
        base = w + rng.integers(0, 5, n)
    c = np.concatenate([ext[:-1] + base, [-1]]).astype(np.int32)
    ids = rng.permutation(n)[:rows].astype(np.int32)
    ids[rng.random(rows) < 0.1] = n
    targets = np.full((rows, w), 7) if kind == "hub" else rng.integers(0, n, (rows, w))
    neigh = np.where(rng.random((rows, w)) < 0.2, n, targets).astype(np.int32)
    return c, ext, ids, neigh


@pytest.mark.parametrize("rows,w,cand,kind", [
    (2, 16384, 1389, "random"),      # hub width: the cluster-split rows
    (3, 4096, 1389, "duplicates"),   # the histogram path, one bin dominant
    (64, 2048, 1389, "duplicates"),
    (37, 8, 1389, "duplicates"),     # the sub-warp path, ragged last block
    (21, 16, 3, "duplicates"),
    (16, 64, 100_000, "random"),     # cand far above the width
    (5, 5, 10**6, "hub"),            # every slot one neighbour
    (4, 1024, 1389, "hub"),
    (3, 2048, 10**6, "hub"),
])
@pytest.mark.parametrize("track_dirty", [True, False])
def test_plain_matches_reference_on_new_path_inputs(rows, w, cand, kind, track_dirty):
    rng = np.random.default_rng(rows * 7 + w)
    c, ext, ids, neigh = _inputs(rng, rows, w, kind)
    n = c.shape[0] - 1
    for _sweep in range(2):
        want = fused_sweep_ref(jnp.asarray(c), jnp.asarray(ext), jnp.asarray(ids),
                               jnp.asarray(neigh), cand=cand, track_dirty=track_dirty)
        got = fused_sweep_op(*(torch.from_numpy(a) for a in (c, ext, ids, neigh)),
                             cand=cand, track_dirty=track_dirty)
        est_r, ch_r, dirty_r = (np.asarray(a) for a in want)
        np.testing.assert_array_equal(got[0].numpy(), est_r)
        np.testing.assert_array_equal(got[1].numpy(), ch_r)
        # The reference also pushes to the sentinel slot n, which no reader
        # looks at; the port never does.
        np.testing.assert_array_equal(got[2].numpy()[:n], dirty_r[:n])
        assert int(got[2][n]) == 0
        c[ids] = got[0].numpy()
        c[-1] = -1
