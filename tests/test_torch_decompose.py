"""The port's decompose engine against the JAX package's, field by field.

For each of the four engines (``sorted | count | kernel | fused``, the
kernels in their plain versions on the CPU), every ``DecomposeResult``
field except ``wall_time_s`` must equal the reference's: coreness,
iterations, the per-sweep changed counts and gathered rows (which pin the
dirty-bit trajectory), peak bytes, the modeled sweep bytes and FLOPs,
``est_dtype`` and ``fused_mode``. Covers the Gauss-Seidel x frontier
matrix, both fused dispatch modes, int16 and its overflow fallback, a
reordered layout, ``init_coreness`` resume, the ``on_sweep`` views and
``seed_nodes``. All comparisons are exact.
"""
import dataclasses
import functools
import inspect
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core.decompose import decompose as ref_decompose
from repro.graph.build import bucketize as ref_bucketize
from repro.graph.generators import barabasi_albert, erdos_renyi, rmat
from repro.graph.oracle import peel_coreness
from repro.graph.reorder import reorder_graph as ref_reorder
from repro.graph.structs import Graph
from repro_torch.core.decompose import DecomposeResult, decompose
from repro_torch.graph.structs import from_reference_arrays

# The graphs here are small and pytest-xdist runs several workers side by
# side: one intra-op thread per worker keeps them from contending for cores.
torch.set_num_threads(1)

ENGINES = ["sorted", "count", "kernel", "fused"]
FORCE_COND = 10**9


def _star_plus_clique(leaves: int, clique: int = 6) -> Graph:
    hub_src = np.zeros(leaves, dtype=np.int64)
    hub_dst = np.arange(1, leaves + 1, dtype=np.int64)
    cs, cd = np.triu_indices(clique, k=1)
    base = leaves + 1
    return Graph.from_edges(np.concatenate([hub_src, cs + base]),
                            np.concatenate([hub_dst, cd + base]),
                            n_nodes=leaves + 1 + clique)


@functools.lru_cache(maxsize=None)
def _graph(name):
    if name == "rmat":
        return rmat(10, 8, seed=7)
    if name == "rmat9":
        return rmat(9, 8, seed=7)
    if name == "er":
        return erdos_renyi(n=1500, avg_deg=8.0, seed=3)
    if name == "ba":
        return barabasi_albert(n=2000, m=5, seed=7)
    if name == "star30000":
        return _star_plus_clique(30_000)
    if name == "star_overflow":
        return _star_plus_clique((1 << 15) + 200)
    raise KeyError(name)


# The reference's cost here is almost all jit compiles, one for each tile
# layout and engine setting, so the tests share a few small layouts.
@functools.lru_cache(maxsize=None)
def _bucketed(name, max_bucket_rows="auto", reorder="identity"):
    return ref_bucketize(ref_reorder(_graph(name), reorder),
                         max_bucket_rows=max_bucket_rows)


def _both(bg, **kw):
    ref = ref_decompose(bg, **kw)
    port = decompose(from_reference_arrays(bg), device="cpu", **kw)
    return ref, port


def _assert_result_equal(ref, port):
    assert isinstance(port, DecomposeResult)
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(port)]
    for name in names:
        if name == "wall_time_s":
            continue
        a, b = getattr(ref, name), getattr(port, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize("graph", ["rmat", "er", "ba"])
@pytest.mark.parametrize("op", ENGINES)
def test_engines_match_reference(graph, op):
    ref, port = _both(_bucketed(graph), op=op)
    _assert_result_equal(ref, port)
    np.testing.assert_array_equal(port.coreness, peel_coreness(_graph(graph)))


# "sorted" stands for the unfused engines here: sorted, count and kernel
# share the port's sweep body and differ only in the h-index op, and the
# reference compiles "sorted" fastest.
@pytest.mark.parametrize("op", ["sorted", "fused"])
@pytest.mark.parametrize("gauss_seidel", [True, False])
@pytest.mark.parametrize("frontier", [True, False])
def test_schedule_matrix(op, gauss_seidel, frontier):
    ref, port = _both(_bucketed("rmat"), op=op, gauss_seidel=gauss_seidel,
                      frontier=frontier, fused_compaction_min_tiles=FORCE_COND)
    _assert_result_equal(ref, port)


@pytest.mark.parametrize("gauss_seidel", [True, False])
@pytest.mark.parametrize("int16", [False, True])
def test_fused_compaction_dispatch(gauss_seidel, int16):
    ref, port = _both(_bucketed("rmat9", 16), op="fused", gauss_seidel=gauss_seidel,
                      int16=int16, fused_compaction_min_tiles=1)
    assert port.fused_mode == "compaction"
    _assert_result_equal(ref, port)


def test_fused_dispatch_crossover_default():
    def default(fn):
        return inspect.signature(fn).parameters["fused_compaction_min_tiles"].default
    assert default(decompose) == default(ref_decompose)
    # At the crossover the compaction dispatch takes over; below it, cond.
    bg = _bucketed("rmat9", 16)
    ref, port = _both(bg, op="fused", fused_compaction_min_tiles=len(bg.buckets))
    assert port.fused_mode == "compaction"
    _assert_result_equal(ref, port)
    bg = _bucketed("rmat")
    assert len(bg.buckets) < default(decompose)
    ref, port = _both(bg, op="fused")
    assert port.fused_mode == "cond"
    _assert_result_equal(ref, port)


def test_fused_compaction_width_classes_out_of_bucket_order():
    """The compaction dispatch groups tiles by width, not by position: with
    the buckets dealt round-robin over the width classes (``bucket_adj`` and
    ``node_bucket`` permuted to match), every class of several tiles is
    split up, and the run still equals the reference field by field."""
    bg = _bucketed("rmat9", 16)
    by_width: dict = {}
    for bi, b in enumerate(bg.buckets):
        by_width.setdefault(b.width, []).append(bi)
    order = sorted(range(len(bg.buckets)), key=lambda bi: (
        by_width[bg.buckets[bi].width].index(bi), bg.buckets[bi].width))
    new_of = np.empty(len(order), np.int64)
    new_of[order] = np.arange(len(order))
    owner = np.asarray(bg.node_bucket)
    dealt = dataclasses.replace(
        bg, buckets=[bg.buckets[bi] for bi in order],
        bucket_adj=np.asarray(bg.bucket_adj)[np.ix_(order, order)],
        node_bucket=np.where(owner >= 0, new_of[np.maximum(owner, 0)], -1).astype(owner.dtype))
    for width in by_width:
        at = [i for i, b in enumerate(dealt.buckets) if b.width == width]
        assert len(at) == 1 or at[-1] - at[0] >= len(at), width  # split up
    ref, port = _both(dealt, op="fused", fused_compaction_min_tiles=1)
    assert port.fused_mode == "compaction"
    _assert_result_equal(ref, port)
    np.testing.assert_array_equal(port.coreness, peel_coreness(_graph("rmat9")))


@pytest.mark.parametrize("graph", ["rmat", "star30000"])
def test_int16_mode(graph):
    # The star's hub row is one tile whatever the split; None keeps its
    # 30,000 leaves in one tile too, a much smaller program to compile.
    bg = _bucketed(graph, None if graph.startswith("star") else "auto")
    ref, port = _both(bg, op="fused", int16=True)
    assert port.est_dtype == "int16"
    _assert_result_equal(ref, port)


def test_int16_overflow_falls_back_to_int32():
    ref, port = _both(_bucketed("star_overflow", None), op="fused", int16=True)
    assert port.est_dtype == "int32"
    _assert_result_equal(ref, port)


@functools.lru_cache(maxsize=None)
def _ext_part(max_start: int):
    """rmat9 with ``ext`` > 0 on most rows and its largest ``deg + ext`` at
    ``max_start``."""
    g = _graph("rmat9")
    deg = np.diff(g.indptr).astype(np.int64)
    ext = (np.arange(g.n_nodes) % 5).astype(np.int32)
    top = int(np.argmax(deg))
    ext[top] = max_start - deg[top]
    return ref_bucketize(g, ext=ext)


@pytest.mark.parametrize("case", [(1 << 15) - 1, 1 << 15, "star_overflow"])
def test_int16_guard_on_the_device_equals_the_host_guard(case):
    """The call's guard, taken from ``deg + ext`` on the device, against the
    int64 host guard it replaced; the window (``cand``) pins the modeled
    sweep cost, which the full comparison checks."""
    bg = _bucketed("star_overflow", None) if case == "star_overflow" else _ext_part(case)
    host_fits = int((bg.degrees.astype(np.int64) + np.asarray(bg.ext, np.int64))
                    .max(initial=0)) < (1 << 15)
    assert host_fits == (case == (1 << 15) - 1)
    ref, port = _both(bg, op="fused", int16=True)
    assert port.est_dtype == ("int16" if host_fits else "int32")
    _assert_result_equal(ref, port)


@pytest.mark.parametrize("resume", [False, True])
def test_call_set_up_runs_no_host_hindex(monkeypatch, resume):
    """With the host h-index made to raise, a traced call still equals the
    reference and records each set-up span once."""
    def boom(*args, **kwargs):
        raise AssertionError("the call sorted its start values on the host")

    monkeypatch.setattr(sys.modules["repro_torch.core.hindex"], "hindex_of_sequence", boom)
    monkeypatch.setattr(sys.modules["repro_torch.core.decompose"], "hindex_of_sequence",
                        boom, raising=False)
    bg = _ext_part((1 << 15) - 1)
    kw = dict(op="fused", int16=True)
    if resume:
        # A valid upper bound of the coreness other than the default start.
        exact = ref_decompose(bg, **kw).coreness.astype(np.int64)
        start = np.minimum(exact + 1, bg.degrees.astype(np.int64) + bg.ext)
        kw["init_coreness"] = start.astype(np.int32)
    ref = ref_decompose(bg, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port = decompose(from_reference_arrays(bg), device="cpu", **kw)
    np.testing.assert_array_equal(port.coreness, ref.coreness)
    assert port.iterations == ref.iterations
    assert port.est_dtype == ref.est_dtype == "int16"
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    for name in ("guard", "start", "cand"):
        assert names.count(f"repro_torch.decompose.{name}") == 1, name


def test_int16_requires_fused():
    with pytest.raises(ValueError, match="int16"):
        decompose(from_reference_arrays(_bucketed("rmat")), op="sorted",
                  int16=True, device="cpu")


@pytest.mark.parametrize("op", ["sorted", "fused"])
@pytest.mark.parametrize("reorder", ["rcm", "bfs"])
def test_reordered_layout(op, reorder):
    ref, port = _both(_bucketed("rmat", "auto", reorder), op=op)
    _assert_result_equal(ref, port)


@pytest.mark.parametrize("op,int16", [("sorted", False), ("kernel", False),
                                      ("fused", False), ("fused", True)])
def test_on_sweep_views_and_init_coreness_resume(op, int16):
    bg = _bucketed("rmat", "auto", "rcm")
    ref_views, port_views = [], []
    ref = ref_decompose(bg, op=op, int16=int16,
                        on_sweep=lambda it, v: ref_views.append((it, np.asarray(v))))
    port = decompose(from_reference_arrays(bg), op=op, int16=int16, device="cpu",
                     on_sweep=lambda it, v: port_views.append((it, v)))
    _assert_result_equal(ref, port)
    assert [it for it, _ in port_views] == [it for it, _ in ref_views]
    for (_, a), (_, b) in zip(ref_views, port_views):
        assert isinstance(b, torch.Tensor) and b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), a)
    # Resume from a mid-run snapshot: the same input to both packages.
    mid = ref_views[min(2, len(ref_views) - 1)][1]
    ref_r, port_r = _both(bg, op=op, int16=int16, init_coreness=mid)
    _assert_result_equal(ref_r, port_r)
    # The port also takes its own tensor view as the snapshot.
    port_t = decompose(from_reference_arrays(bg), op=op, int16=int16, device="cpu",
                       init_coreness=port_views[min(2, len(port_views) - 1)][1])
    _assert_result_equal(ref_r, port_t)


@pytest.mark.parametrize("op,seed_kind", [(op, "ids") for op in ENGINES]
                         + [("fused", "mask")])
def test_seed_nodes(op, seed_kind):
    g = _graph("rmat")
    bg = _bucketed("rmat", "auto", "rcm")
    # Warm start from the fixed point with a few nodes raised: only their
    # buckets (and what the dirty bits re-activate) sweep.
    core = peel_coreness(g)
    init = core.copy()
    bumped = np.arange(0, g.n_nodes, 97)
    init[bumped] += 3
    seeds = bumped if seed_kind == "ids" else np.isin(np.arange(g.n_nodes), bumped)
    ref, port = _both(bg, op=op, init_coreness=init, seed_nodes=seeds)
    _assert_result_equal(ref, port)
    assert port.gathered_rows < port.full_sweep_rows


def test_max_iter_and_seed_validation():
    bg = _bucketed("rmat")
    ref, port = _both(bg, op="count", max_iter=2)
    _assert_result_equal(ref, port)
    assert port.iterations == 2
    with pytest.raises(ValueError, match="frontier"):
        decompose(from_reference_arrays(bg), seed_nodes=np.arange(3),
                  frontier=False, device="cpu")
    with pytest.raises(ValueError, match="unknown op"):
        decompose(from_reference_arrays(bg), op="nope", device="cpu")


def test_default_device_is_cuda_and_never_falls_back():
    bg = from_reference_arrays(_bucketed("rmat"))
    if torch.cuda.is_available():
        assert decompose(bg, op="fused").iterations > 0
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            decompose(bg, op="fused")
