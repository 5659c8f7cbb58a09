"""The benchmark's graph generators and CSR build, on the CPU at small scales."""
import json

import numpy as np
import pytest
import torch

from perfbench import graph, spec


def small(config: str, scale: int = 10) -> dict:
    cfg = spec.load_config(config)
    cfg["scale"] = scale
    return cfg


@pytest.mark.parametrize("config", ["gap-kron-s24", "gap-urand-s24"])
def test_same_seed_same_csr(config):
    a = graph.make_csr(small(config), 2**31 + 7, "cpu")
    b = graph.make_csr(small(config), 2**31 + 7, "cpu")
    assert torch.equal(a.indptr, b.indptr) and torch.equal(a.indices, b.indices)


@pytest.mark.parametrize("config", ["gap-kron-s24", "gap-urand-s24"])
def test_seed_permutes_labels_of_one_graph(config):
    """Every seed gets the configuration's one graph, labelled anew."""
    a = graph.make_csr(small(config), 1, "cpu")
    b = graph.make_csr(small(config), 2, "cpu")
    assert a.indices.numel() == b.indices.numel()
    assert not torch.equal(a.indices, b.indices)
    deg_a = np.sort(a.degrees().numpy())
    deg_b = np.sort(b.degrees().numpy())
    assert np.array_equal(deg_a, deg_b)


@pytest.mark.parametrize("config", ["gap-kron-s24", "gap-urand-s24"])
def test_csr_is_simple_symmetric_and_sorted(config):
    csr = graph.make_csr(small(config, 9), 5, "cpu")
    n = csr.n_nodes
    indptr, indices = csr.indptr.numpy(), csr.indices.numpy().astype(np.int64)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    assert indptr[0] == 0 and indptr[-1] == indices.size
    assert not np.any(rows == indices), "self-loop"
    keys = rows * n + indices
    assert np.all(np.diff(keys) > 0), "rows unsorted or an edge twice"
    assert np.array_equal(np.sort(indices * n + rows), keys), "not symmetric"


def test_simple_csr_drops_loops_and_duplicates():
    src = torch.tensor([0, 1, 1, 2, 2, 3])
    dst = torch.tensor([1, 0, 1, 3, 3, 2])
    csr = graph.simple_csr(src, dst, 4)
    assert csr.indptr.tolist() == [0, 1, 2, 3, 4]
    assert csr.indices.tolist() == [1, 0, 3, 2]


def test_kron_quadrants_follow_a_b_c():
    """At one bit the source bit is set with probability 1 - a - b and the
    destination bit with b + (1 - a - b - c)."""
    kron = spec.load_generator("kron")
    params = {"a": 0.57, "b": 0.19, "c": 0.19}
    gen = torch.Generator().manual_seed(3)
    src, dst = kron.edges(1, 1 << 16, params, gen, torch.device("cpu"))
    assert src.max() <= 1 and dst.max() <= 1
    assert abs(src.float().mean().item() - 0.24) < 0.01
    assert abs(dst.float().mean().item() - 0.24) < 0.01
    both = (src & dst).float().mean().item()
    assert abs(both - 0.05) < 0.005


def test_kron_is_skewed_and_urand_is_not():
    kron = graph.make_csr(small("gap-kron-s24", 12), 1, "cpu").degrees()
    urand = graph.make_csr(small("gap-urand-s24", 12), 1, "cpu").degrees()
    assert kron.max() > 20 * kron.float().mean()
    assert urand.max() < 3 * urand.float().mean()
    assert (kron == 0).sum() > 0


def test_configs_name_their_source_and_cut():
    for name in ("gap-kron-s24", "gap-urand-s24"):
        cfg = spec.load_config(name)
        assert cfg["name"] == name
        assert cfg["scale"] == 24 and cfg["edge_factor"] == 16
        assert cfg["published"]["scale"] == 27
        assert cfg["reduced"] == ["scale"]
        assert "1508.03619" in cfg["source"]
        json.dumps(cfg)
