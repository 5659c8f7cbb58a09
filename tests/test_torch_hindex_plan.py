"""The h-index kernel's launch plan -- the fused kernel's -- and its plain
version on the rows of each path, against the JAX package.

``hindex_op`` launches the fused kernel's row paths by
``fused_launch_plan``: it accepts exactly the plans that function makes for
a bucket's shape (forced paths and clusters included) and rejects any other
before it looks at the device. The plain version is held exactly
(integers, tolerance 0) against the JAX package's ``hindex_pallas`` in
interpret mode on rows that each path takes (the exact search forced on
rows a histogram would also take: it is planned only for a candidate
window of more than 57,343 bins).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hindex import hindex_pallas as ref_hindex_pallas
from repro_torch.kernels.hindex import hindex_op, hindex_plain
from repro_torch.kernels.plan import MAX_BINS, MAX_CLUSTER, fused_launch_plan

torch.set_num_threads(1)


def _forced_plans(rows, w, cand):
    """Every plan ``fused_launch_plan`` makes for the shape: the planned
    one, each path that covers the width, each hist cluster."""
    plans = {fused_launch_plan(rows, w, cand)}
    for path in ("group", "warp", "search"):
        try:
            plans.add(fused_launch_plan(rows, w, cand, path=path))
        except ValueError:
            pass
    if min(cand, w) + 1 <= MAX_BINS:
        plans.update(fused_launch_plan(rows, w, cand, path="hist", cluster=k)
                     for k in range(1, MAX_CLUSTER + 1))
    return plans


@pytest.mark.parametrize("rows,w,cand", [
    (37, 8, 1389), (21, 16, 3), (9, 64, 130), (3, 1024, 50), (3, 2048, 1389),
    (2, 4096, 300),
])
def test_hindex_op_accepts_every_plan_of_the_shape(rows, w, cand):
    rng = np.random.default_rng(rows + w)
    x = torch.from_numpy(rng.integers(-1, w + 5, size=(rows, w)).astype(np.int32))
    ext = torch.from_numpy(rng.integers(0, 4, size=rows).astype(np.int32))
    want = hindex_plain(x, ext, cand=cand)
    plans = _forced_plans(rows, w, cand)
    assert {"hist", "search"} <= {p.path for p in plans}
    for plan in plans:
        assert torch.equal(hindex_op(x, ext, cand=cand, plan=plan), want), plan


def test_hindex_op_rejects_other_plans():
    x = torch.full((4, 8), 3, dtype=torch.int32)
    ext = torch.zeros(4, dtype=torch.int32)
    before = hindex_op.launches
    ok = fused_launch_plan(4, 8, 8, path="hist", cluster=2)
    hindex_op(x, ext, cand=8, plan=ok)
    for bad in (fused_launch_plan(400, 8, 8), fused_launch_plan(4, 16, 8),
                fused_launch_plan(4, 8, 8)._replace(group=16),
                ok._replace(threads=512), ok._replace(smem_bytes=4), ok._replace(cluster=0),
                ok._replace(blocks=4), ok._replace(path="block")):
        with pytest.raises(ValueError, match="launch plan"):
            hindex_op(x, ext, cand=8, plan=bad)
    assert hindex_op.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("rows,w,cand,path", [
    (37, 8, 1389, "group"),    # 8 lanes a row, a ragged last block
    (21, 16, 3, "group"),      # 16 lanes a row, cand under the width
    (5, 5, 1389, "group"),
    (1, 1, 1, "group"),
    (9, 64, 130, "warp"),
    (3, 1024, 50, "warp"),
    (7, 33, 1389, "warp"),
    (3, 2048, 1389, "hist"),   # one block a row
    (2, 4096, 300, "hist"),    # a cluster of 4 a row
    (3, 2048, 1389, "search"),  # forced: planned only when the bins exceed shared memory
    (1, 4096, 4096, "search"),
])
def test_plain_matches_pallas_on_path_rows(rows, w, cand, path):
    rng = np.random.default_rng(rows * 17 + w)
    rows8 = -(-rows // 8) * 8  # hindex_pallas takes whole tiles of 8 rows
    x = rng.integers(-1, min(cand, w) + 6, size=(rows8, w))
    x[: rows8 // 2, : w // 3] = 3  # rows of one repeated estimate: one bin takes many slots
    x = np.where(rng.random((rows8, w)) < 0.2, -1, x).astype(np.int32)
    ext = rng.integers(0, 4, size=rows8).astype(np.int32)
    cur = ext + min(cand, w) + 1  # an estimate above every candidate: no chunk is skipped
    plan = fused_launch_plan(rows, w, cand, path=None if path != "search" else path)
    assert plan.path == path
    want = np.asarray(ref_hindex_pallas(jnp.asarray(x), jnp.asarray(ext), jnp.asarray(cur),
                                        cand=cand))[:rows]
    got = hindex_op(torch.from_numpy(x[:rows]), torch.from_numpy(ext[:rows]), cand=cand,
                    plan=plan)
    np.testing.assert_array_equal(got.numpy(), want)
