// The binary-search row paths of the two k-core h-index kernels (fused.cu,
// hindex.cu): a warp per row up to 1,024 slots, and a block per row with
// the exact search for a bound whose histogram bins exceed shared memory.
// hist_common.cuh holds the other two paths and the launcher of both files.
//
// Both kernels compute, per row r of a padded [rows, width] neighbour tile,
//
//     h(r) = max{ i in [0, B] : #{ j : y[r, j] >= i } >= i },  B = min(cand, width)
//
// over y = (neighbour estimate) - ext[r]; pad slots hold estimate -1, so
// their y is below 1 and never counts. The Pallas TPU kernels evaluate this
// as a dense [tile, width, cand_chunk] compare because sorting is hostile
// to the VPU. Here the feasibility test "#{y >= i} >= i" is monotone in i
// (if i is feasible, so is i - 1), so h is found by a binary search over
// [0, hi] with hi = min(B, #{y >= 1}, max y): ceil(log2(hi + 1)) counting
// passes over the row instead of cand passes. The result is the exact
// clamped h-index, the same function as the plain PyTorch versions, on
// every input (no predication on the current estimate is needed).
//   * row_per_warp:  width/32 values per lane in registers, counts reduced
//                    with __reduce_add_sync; the row is read once;
//   * row_per_block: 1,024 threads per row; each counting pass re-reads the
//                    row (from L1/L2 after the first pass) and reduces
//                    across the block through shared memory.
//
// A kernel body is written once against a row policy P:
//   P::Row  row(r)                      per-row state (ext, ...)
//   int     slot(R, j, &nb)             y of slot j; nb = neighbour id
//   int     neighbor(R, j)              neighbour id of slot j
//   bool    finish(r, R, h, write)      write outputs (if write); returns
//                                       whether the row's neighbours are pushed
//   void    push(nb)                    the dirty-bit push of one neighbour
//   static constexpr bool kAggregateBins  whether the hist path aggregates
//                                       equal bins of a warp (hist_common.cuh)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kcore {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreadBlock = 256;      // warp path: threads per block
constexpr int kRowBlock = 1024;        // block path: threads per hub row
constexpr int kWarpMaxWidth = 1024;

template <int N>
__device__ __forceinline__ int count_ge(const int (&y)[N], int t) {
  int c = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) c += (y[k] >= t) ? 1 : 0;
  return c;
}

template <int N>
__device__ __forceinline__ int max_of(const int (&y)[N]) {
  int m = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) m = max(m, y[k]);
  return m;
}

// Largest feasible i in [0, hi]; count(t) = #{y >= t} (uniform across the
// threads that cooperate on the row, so the loop is uniform too).
template <typename Count>
__device__ __forceinline__ int hindex_search(int hi, Count count) {
  int lo = 0;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (count(mid) >= mid) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Block-wide sum / max; red holds 33 ints of shared memory.
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = static_cast<int>(__reduce_add_sync(kFullMask, static_cast<unsigned>(v)));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = (lane < static_cast<int>(blockDim.x >> 5)) ? red[lane] : 0;
    t = static_cast<int>(__reduce_add_sync(kFullMask, static_cast<unsigned>(t)));
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ int block_max(int v, int* red) {
  v = __reduce_max_sync(kFullMask, v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = (lane < static_cast<int>(blockDim.x >> 5)) ? red[lane] : 0;
    t = __reduce_max_sync(kFullMask, t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

template <int VPT, class P>
__global__ void __launch_bounds__(kThreadBlock)
row_per_warp(P p, int rows, int width, int bound) {
  // 64-bit: rows * 32 threads may pass 2^31 on a large tile.
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;  // uniform across the warp
  const int r = static_cast<int>(warp);
  const typename P::Row R = p.row(r);
  int y[VPT];
  int nb[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = lane + 32 * k;
    y[k] = -1;
    nb[k] = 0;
    if (j < width) y[k] = p.slot(R, j, nb[k]);
  }
  const int pos = static_cast<int>(
      __reduce_add_sync(kFullMask, static_cast<unsigned>(count_ge(y, 1))));
  const int mx = __reduce_max_sync(kFullMask, max_of(y));
  const int hi = min(bound, min(pos, mx));
  const int h = hindex_search(hi, [&](int t) {
    return static_cast<int>(
        __reduce_add_sync(kFullMask, static_cast<unsigned>(count_ge(y, t))));
  });
  if (p.finish(r, R, h, lane == 0)) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (lane + 32 * k < width) p.push(nb[k]);
    }
  }
}

template <class P>
__global__ void __launch_bounds__(kRowBlock)
row_per_block(P p, int rows, int width, int bound) {
  __shared__ int red[33];
  const int r = blockIdx.x;
  const typename P::Row R = p.row(r);
  int pos = 0;
  int mx = 0;
  int nb;
#pragma unroll 4
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    const int v = p.slot(R, j, nb);
    pos += (v >= 1) ? 1 : 0;
    mx = max(mx, v);
  }
  pos = block_sum(pos, red);
  mx = block_max(mx, red);
  const int hi = min(bound, min(pos, mx));
  const int h = hindex_search(hi, [&](int t) {
    int cnt = 0;
#pragma unroll 4
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
      cnt += (p.slot(R, j, nb) >= t) ? 1 : 0;
    }
    return block_sum(cnt, red);
  });
  if (p.finish(r, R, h, threadIdx.x == 0)) {
    for (int j = threadIdx.x; j < width; j += blockDim.x) p.push(p.neighbor(R, j));
  }
}

}  // namespace kcore
