"""The staged host-to-device upload (``core/upload.py``) and the tiles built
from it (``core/decompose.py::_Tiles``).

On the CPU: the piece plan as a pure function of the array's size, the
direct path (no staging, tensors that share the numpy memory), and
``_Tiles``' row ids, row keys and real-row mask against the host formula
they replaced. Marked ``cuda`` (skip without a GPU): the staged upload bit
for bit against ``.to("cuda")``, four threads on four streams at once, a
decomposition whose tiles exceed the ring, and the byte counters. Run on the
card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_upload.py
"""
import sys
import threading

import numpy as np
import pytest
import torch

import repro_torch.core.decompose  # noqa: F401  (the module, below)
from repro_torch.core.upload import (CHUNK_BYTES, RING_CHUNKS, STAGE_MIN_BYTES,
                                     piece_plan, to_device)
from repro_torch.graph.build import bucketize
from repro_torch.graph.generators import erdos_renyi, rmat
from repro_torch.graph.structs import Graph

decompose_module = sys.modules["repro_torch.core.decompose"]

RING_BYTES = RING_CHUNKS * CHUNK_BYTES


@pytest.mark.parametrize("nbytes", [
    0, 1, STAGE_MIN_BYTES - 1, STAGE_MIN_BYTES, CHUNK_BYTES, CHUNK_BYTES + 1,
    RING_BYTES, RING_BYTES + CHUNK_BYTES // 2 + 3,
])
def test_piece_plan(nbytes):
    plan = piece_plan(nbytes)
    if nbytes < STAGE_MIN_BYTES:
        assert plan == []
        return
    assert plan[0][0] == 0 and plan[-1][1] == nbytes
    for i, (start, stop, chunk) in enumerate(plan):
        assert start == i * CHUNK_BYTES
        assert 0 < stop - start <= CHUNK_BYTES
        assert chunk == i % RING_CHUNKS
    assert len(plan) == -(-nbytes // CHUNK_BYTES)


def test_cpu_path_stages_nothing():
    big = np.arange(2 * STAGE_MIN_BYTES // 4, dtype=np.int32).reshape(-1, 8)
    small = np.arange(10, dtype=np.int32)
    staged, direct = to_device.staged_bytes, to_device.direct_bytes
    outs = [to_device(a, torch.int32, torch.device("cpu")) for a in (big, small)]
    assert to_device.staged_bytes == staged
    assert to_device.direct_bytes >= direct + big.nbytes + small.nbytes
    for a, t in zip((big, small), outs):
        assert t.dtype == torch.int32 and tuple(t.shape) == a.shape
        assert np.shares_memory(t.numpy(), a)
    widened = to_device(small, torch.int64, "cpu")
    assert widened.dtype == torch.int64
    np.testing.assert_array_equal(widened.numpy(), small)


def _cycle(n):
    return Graph.from_edges(np.arange(n), (np.arange(n) + 1) % n, n_nodes=n)


BUCKETINGS = {
    "no_buckets": lambda: bucketize(Graph.from_edges(
        np.zeros(0, np.int64), np.zeros(0, np.int64), n_nodes=5)),
    "one_bucket": lambda: bucketize(_cycle(16)),
    "pad_rows": lambda: bucketize(_cycle(13)),
    "many_tiles": lambda: bucketize(rmat(10, 8, seed=7), max_bucket_rows=8),
}


@pytest.mark.parametrize("name", sorted(BUCKETINGS))
def test_tiles_match_host_formula(name):
    bg = BUCKETINGS[name]()
    n = bg.n_nodes
    tiles = decompose_module._Tiles(bg, torch.device("cpu"))
    nb = len(bg.buckets)
    # The host formula the tiles used before they were built from the
    # uploaded buckets.
    all_ids = (np.concatenate([b.node_ids for b in bg.buckets])
               if nb else np.zeros(0, np.int32))
    want_ids = torch.as_tensor(all_ids, dtype=torch.int32)
    want_tile_of = torch.as_tensor(np.concatenate(
        [np.full(b.n_rows, bi, np.int64) for bi, b in enumerate(bg.buckets)]
    ) if nb else np.zeros(0, np.int64))
    for got, want in ((tiles.all_ids, want_ids), (tiles.tile_of, want_tile_of),
                      (tiles.real, want_ids != n)):
        assert got.dtype == want.dtype and got.device.type == "cpu"
        assert torch.equal(got, want)
    if name == "pad_rows":
        assert not bool(tiles.real.all())
    if name == "many_tiles":
        assert nb > 8
    for (ids, neigh), b in zip(tiles.buckets, bg.buckets):
        assert np.shares_memory(ids.numpy(), b.node_ids)
        assert np.shares_memory(neigh.numpy(), b.neigh)


# -- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staged upload copies through "
                    "page-locked memory to the card")
    return torch.device("cuda")


def _int32(shape, seed):
    return np.random.default_rng(seed).integers(
        -2**31, 2**31 - 1, size=shape, dtype=np.int32)


SIZES = [STAGE_MIN_BYTES - 4, STAGE_MIN_BYTES, CHUNK_BYTES - 4, CHUNK_BYTES,
         CHUNK_BYTES + 4, 3 * CHUNK_BYTES + 100, RING_BYTES + CHUNK_BYTES + 8]


@pytest.mark.cuda
@pytest.mark.parametrize("width", [None, 8, 37])
@pytest.mark.parametrize("nbytes", SIZES)
def test_staged_upload_equals_to_cuda(dev, nbytes, width):
    n = nbytes // 4
    shape = (n,) if width is None else (n // width, width)
    a = _int32(shape, nbytes + (width or 0))
    staged, direct = to_device.staged_bytes, to_device.direct_bytes
    got = to_device(a, torch.int32, dev)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, torch.as_tensor(a).to(dev))
    if a.nbytes >= STAGE_MIN_BYTES:
        assert to_device.staged_bytes - staged == a.nbytes
    else:
        assert to_device.direct_bytes - direct == a.nbytes
        assert to_device.staged_bytes == staged


@pytest.mark.cuda
def test_four_streams_upload_at_once(dev):
    arrays = [_int32((CHUNK_BYTES // 4 * 3 + 5 * i + 1,), 100 + i) for i in range(4)]
    shared = _int32((RING_BYTES // 16 + 3, 16), 99)
    want = [torch.as_tensor(a).to(dev) for a in arrays + [shared]]
    got = [None] * 4
    errors = []
    start = threading.Barrier(4)

    def work(i):
        try:
            stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(stream):
                start.wait(timeout=60)
                mine = [to_device(a, torch.int32, dev) for a in (arrays[i], shared)]
                mine += [to_device(a, torch.int32, dev) for a in arrays]
            stream.synchronize()
            got[i] = mine
        except Exception as e:  # reported below, with the thread's index
            errors.append((i, repr(e)))

    staged = to_device.staged_bytes
    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for i, mine in enumerate(got):
        assert torch.equal(mine[0], want[i]) and torch.equal(mine[1], want[4])
        for tensor, w in zip(mine[2:], want[:4]):
            assert torch.equal(tensor, w)
    # Thread i sent arrays[i], shared and every array of ``arrays``.
    assert to_device.staged_bytes - staged == (
        5 * sum(a.nbytes for a in arrays) + 4 * shared.nbytes)


@pytest.mark.cuda
def test_decompose_with_tiles_past_the_ring(dev):
    from repro_torch.core.decompose import decompose

    bg = bucketize(erdos_renyi(n=1 << 20, avg_deg=32.0, seed=3), max_bucket_rows=None)
    tile_bytes = sum(b.node_ids.nbytes + b.neigh.nbytes for b in bg.buckets)
    want_staged = sum(a.nbytes for b in bg.buckets for a in (b.node_ids, b.neigh)
                      if a.nbytes >= STAGE_MIN_BYTES)
    assert tile_bytes > RING_BYTES
    assert max(b.neigh.nbytes for b in bg.buckets) > CHUNK_BYTES
    staged = to_device.staged_bytes
    got = decompose(bg, op="fused", int16=True, device=dev)
    assert to_device.staged_bytes - staged == want_staged
    want = decompose(bg, op="sorted", device="cpu")
    np.testing.assert_array_equal(got.coreness, want.coreness)
    assert got.iterations == want.iterations
    assert got.comm_per_iter == want.comm_per_iter
    assert got.active_rows_per_iter == want.active_rows_per_iter
