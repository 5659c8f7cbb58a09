// Fused sweep kernel: gather + h-index + dirty push for one bucket
// (engine="fused").
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused/fused.py
// (_fused_sweep_kernel, launched by fused_sweep_pallas). Per row r of
// ids [rows] / neigh [rows, width] (pads = n, the sentinel):
//     x        = c[neigh[r, :]]                 (int16 or int32 c, widened)
//     est[r]   = ext_pad[ids[r]] + h-index of x over [1, min(cand, width)]
//     changed  = est[r] != c[ids[r]]  and  ids[r] != n
//     dirty[neigh[r, j]] = 1 for every real neighbour of a changed row.
// est goes to its own output, never into c, so the reads of one launch are
// Jacobi, as in the reference (it reads c before it scatters).
//
// What bounds it on the H100: bytes in principle (the tile's ids read once,
// c, ext and the outputs), about 0.06 ms for a full sweep of rmat(20, 16).
// In practice two things the bound does not count: the random 2- or 4-byte
// reads of c (each costs an L2 sector; c and dirty both fit in the 50 MB
// L2), and the push, whose byte stores pile onto the hub nodes' addresses,
// which sit in most rows' lists. The h-index arithmetic is far below the
// INT32 rate on every path.
//
// What the design does about it, by width class (one launch per bucket;
// the launch plan -- path, block size, grid, cluster, shared memory -- is
// computed in Python, kernels/plan.py::fused_launch_plan, and this file
// only launches it, through hist_common.cuh launch_row_plan):
//   * width <= 16: a group of 8 or 16 lanes per row, one slot per lane
//     (hist_common.cuh row_per_group), so loads are contiguous across a
//     warp and a 10 k-row tile spreads over every SM;
//   * width <= 1024: a warp per row, values in registers, binary search
//     (hindex_common.cuh row_per_warp);
//   * wider: a shared-memory histogram per row, each slot read and
//     gathered once (hist_common.cuh row_per_cluster), the row split over a
//     thread-block cluster when the tile has too few rows to fill the card;
//     a bound whose bins exceed shared memory takes the exact binary search
//     of hindex_common.cuh row_per_block instead.
// On every path a row's ids are read once for the h-index (and once more
// by a changed wide row's push), an int16 c halves the gathered bytes and
// is widened in registers, and the push tests before it sets: a byte that
// already reads 1 is not stored again, which turns most of the stores to
// hub addresses into cached reads. A stale 0 costs only one more idempotent
// store of 1, so no atomics or fences are needed. It pays across a sweep,
// whose later buckets find most bytes already set: in a full sweep of
// rmat(20, 16) on an H100 it cut the push from 0.90 to 0.15 ms, though a
// bucket pushing into a freshly zeroed buffer alone runs slower with it
// than with plain stores (chip_smoke.py prints both). The caller zeroes `dirty`
// before the first launch of a sweep (CUDA blocks have no order in which one
// could zero it), and pushes to the sentinel slot n are skipped (that slot
// is never read).
#include "hist_common.cuh"

namespace {

template <typename T>
struct FusedPolicy {
  // The hist path aggregates equal bins of a warp before its shared
  // atomics, as measured when this kernel was redesigned (hist_common.cuh
  // bin_slots).
  static constexpr bool kAggregateBins = true;

  const T* __restrict__ c;
  const int32_t* __restrict__ ext_pad;
  const int32_t* __restrict__ ids;
  const int32_t* __restrict__ neigh;
  int32_t* __restrict__ est;
  int32_t* __restrict__ changed;
  int8_t* __restrict__ dirty;
  int width;
  int sentinel;
  bool track_dirty;

  struct Row {
    int id;
    int e;
    int cur;
    int64_t base;
  };

  __device__ __forceinline__ Row row(int r) const {
    const int id = __ldg(ids + r);
    return Row{id, __ldg(ext_pad + id), static_cast<int>(__ldg(c + id)),
               static_cast<int64_t>(r) * width};
  }
  __device__ __forceinline__ int neighbor(const Row& R, int j) const {
    return __ldg(neigh + R.base + j);
  }
  __device__ __forceinline__ int slot(const Row& R, int j, int& nb) const {
    nb = neighbor(R, j);
    return static_cast<int>(__ldg(c + nb)) - R.e;
  }
  __device__ __forceinline__ bool finish(int r, const Row& R, int h, bool write) const {
    const int e = R.e + h;
    const bool ch = (e != R.cur) && (R.id != sentinel);
    if (write) {
      est[r] = e;
      changed[r] = ch ? 1 : 0;
    }
    return ch && track_dirty;
  }
  // Test before set: a plain load (never stale as 1 -- bytes only go from 0
  // to 1 within a sweep), and a store only where it read 0.
  __device__ __forceinline__ void push(int nb) const {
    if (nb != sentinel && dirty[nb] == 0) dirty[nb] = 1;
  }
};

template <typename T>
cudaError_t launch(const void* c, const int32_t* ext_pad, const int32_t* ids,
                   const int32_t* neigh, int32_t* est, int32_t* changed, int8_t* dirty,
                   int rows, int width, int bound, int sentinel, bool track_dirty,
                   int path, int threads, int blocks, int cluster, int smem_bytes,
                   int group, cudaStream_t s) {
  using P = FusedPolicy<T>;
  const P p{static_cast<const T*>(c), ext_pad, ids, neigh, est,
            changed, dirty, width, sentinel, track_dirty};
  return kcore::launch_row_plan(p, rows, width, bound, path, threads, blocks, cluster,
                               smem_bytes, group, s);
}

}  // namespace

// c [n+1] int16 (c_bytes 2) or int32 (c_bytes 4), slot n = -1;
// ext_pad [n+1] int32; ids [rows] int32; neigh [rows, width] int32 (pads
// = n); outputs est, changed [rows] int32; dirty [n+1] int8 (stored into,
// not zeroed). path / threads / blocks / cluster / smem_bytes / group are
// the launch plan of kernels/plan.py::fused_launch_plan for these shapes.
// Launches on `stream`; returns the launch's error, else cudaGetLastError()
// after it.
extern "C" int kcore_fused_sweep(const void* c, int c_bytes, const int32_t* ext_pad,
                                 const int32_t* ids, const int32_t* neigh,
                                 int32_t* est, int32_t* changed, int8_t* dirty,
                                 int n, int rows, int width, int cand,
                                 int track_dirty, int path, int threads, int blocks,
                                 int cluster, int smem_bytes, int group, void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  const int bound = min(max(cand, 1), width);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (c_bytes == 2)
          ? launch<int16_t>(c, ext_pad, ids, neigh, est, changed, dirty, rows, width, bound,
                            n, track_dirty != 0, path, threads, blocks, cluster,
                            smem_bytes, group, s)
          : launch<int32_t>(c, ext_pad, ids, neigh, est, changed, dirty, rows, width, bound,
                            n, track_dirty != 0, path, threads, blocks, cluster,
                            smem_bytes, group, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
