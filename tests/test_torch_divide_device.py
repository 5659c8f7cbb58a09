"""DC-kCore's divide passes on the card (``dc_kcore(divide_device=...)``)
against the host passes. The CPU tests of the same path, against the JAX
package, are in ``test_torch_graph.py`` and ``test_torch_dckcore.py``; these
run on a GPU only and skip without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dckcore import dc_kcore
from repro_torch.core.divide import exact_candidates
from repro_torch.graph.build import external_info, induced_subgraph
from repro_torch.graph.generators import rmat


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the divide passes run as torch ops there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_passes_on_the_card_equal_the_host_passes(dev, seed):
    g = rmat(12, 8, seed=seed)
    rng = np.random.default_rng(seed)
    keep = rng.random(g.n_nodes) < 0.6
    upper = ~keep & (rng.random(g.n_nodes) < 0.5)
    hsub, hids = induced_subgraph(g, keep)
    csub, cids = induced_subgraph(g, keep, device=dev)
    np.testing.assert_array_equal(csub.indptr, hsub.indptr)
    np.testing.assert_array_equal(csub.indices, hsub.indices)
    np.testing.assert_array_equal(cids, hids)
    np.testing.assert_array_equal(external_info(g, keep, upper, device=dev),
                                  external_info(g, keep, upper))
    ext = rng.integers(0, 4, g.n_nodes).astype(np.int32)
    for t in (4, 16, 64):
        np.testing.assert_array_equal(exact_candidates(g, ext, t, device=dev),
                                      exact_candidates(g, ext, t))


@pytest.mark.cuda
@pytest.mark.parametrize("thresholds", [(8,), (24, 6)])
def test_dc_kcore_divided_on_the_card_equals_the_host_divide(dev, thresholds):
    g = rmat(12, 8, seed=7)
    kw = dict(strategy="exact", engine="fused", int16=True, device="cuda")
    host_core, host = dc_kcore(g, thresholds, **kw)
    card_core, card = dc_kcore(g, thresholds, divide_device=dev, **kw)
    np.testing.assert_array_equal(card_core, host_core)
    assert ([(p.n_nodes, p.n_edges, p.iterations) for p in card.parts]
            == [(p.n_nodes, p.n_edges, p.iterations) for p in host.parts])
