// One-pass h-index rows for Hopper: a sub-warp group per narrow row and a
// shared-memory histogram per wide row, the latter split over a thread-block
// cluster when the tile has too few rows to fill the card.
//
// Both compute the clamped h-index of hindex_common.cuh,
//
//     h(r) = max{ i in [0, B] : #{ j : y[r, j] >= i } >= i },  B = bound,
//
// against the same row policy P (row / slot / neighbor / finish / push),
// but read each slot once where the binary search of hindex_common.cuh
// reads it once per pass. The fused kernel takes them for its narrow and
// wide rows; the h-index and counts kernels can adopt them later.
#pragma once

#include <cooperative_groups.h>

#include "hindex_common.cuh"

namespace kcore {

constexpr int kGroupBlock = 128;     // sub-warp path: threads per block
constexpr int kHistMaxThreads = 1024;
constexpr int kHistScratch = 64;     // ints after the bins: 33 reduction slots, the push flag
constexpr int kHistFlag = 40;        // offset of the push flag in the scratch ints

// Narrow rows (width <= G, G = 8 or 16): G lanes per row, one slot per lane,
// so a warp's loads of 32 / G consecutive rows are contiguous. With the
// row's values y_l spread over the group,
//
//     h = max(0, max_l min(y_l, #{k : y_k >= y_l}, bound)):
//
// for a feasible i the lane with the least y_l >= i counts #{y >= i} >= i,
// and min(y_l, count_l, bound) is always feasible. That takes G broadcast
// shuffles and a log2(G) max reduction, with no loop that depends on data.
template <int G, class P>
__global__ void __launch_bounds__(kGroupBlock)
row_per_group(P p, int rows, int width, int bound) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((t & ~int64_t{31}) / G >= rows) return;  // the whole warp is past the last row
  const int64_t g = t / G;
  const int j = static_cast<int>(t & (G - 1));
  const bool live = g < rows;  // lanes of a ragged last warp still shuffle
  const int r = live ? static_cast<int>(g) : 0;
  typename P::Row R{};
  int y = -1;
  int nb = 0;
  if (live) {
    R = p.row(r);
    if (j < width) y = p.slot(R, j, nb);
  }
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < G; ++k) cnt += (__shfl_sync(kFullMask, y, k, G) >= y) ? 1 : 0;
  int h = max(0, min(min(y, cnt), bound));
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) h = max(h, __shfl_xor_sync(kFullMask, h, off, G));
  if (live && p.finish(r, R, h, j == 0) && j < width) p.push(nb);
}

// hist[k] counts the slots whose clamped value is k (bin 0 is never
// counted), so sum_{k >= i} hist[k] = #{y >= i} for 1 <= i <= bound. Returns
// the largest i in [0, nbins) with that sum >= i, to every thread of the
// block. Each thread suffix-sums a run of bins; red holds 33 ints.
__device__ __forceinline__ int hist_hindex(const int* hist, int nbins, int* red) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (nbins + blockDim.x - 1) / blockDim.x;
  const int k0 = min(tid * per, nbins);
  const int k1 = min(k0 + per, nbins);
  int local = 0;
  for (int k = k0; k < k1; ++k) local += hist[k];
  int incl = local;  // sum of `local` over this lane and the warp's later lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_down_sync(kFullMask, incl, off);
    if (lane + off < 32) incl += v;
  }
  if (lane == 0) red[warp] = incl;
  __syncthreads();
  int run = incl - local;  // bins after this thread's run
  for (int w = warp + 1; w < static_cast<int>(blockDim.x >> 5); ++w) run += red[w];
  int best = 0;
  for (int k = k1 - 1; k >= k0; --k) {
    run += hist[k];
    if (run >= k) {  // feasibility holds on a prefix of i: the first hit is the run's best
      best = k;
      break;
    }
  }
  __syncthreads();  // red is reused
  return block_max(best, red);
}

// Wide rows: one shared-memory histogram of the clamped values per row, so
// each slot is read and gathered once. A row may be split over a cluster of
// cs blocks (launched with that cluster dimension; the blocks of row r are
// r * cs ... r * cs + cs - 1, in cluster-rank order): every block bins its
// share of the slots; rank q then sums its share of the bins over the
// cluster into the leader's (rank 0) through distributed shared memory; the
// leader finds h, writes the row's outputs and tells every block whether to
// push; each block pushes its share. With cs = 1 it is one block per row.
// Dynamic shared memory: bound + 1 bins, then kHistScratch ints.
template <class P>
__global__ void __launch_bounds__(kHistMaxThreads)
row_per_cluster(P p, int rows, int width, int bound) {
  namespace cg = cooperative_groups;
  extern __shared__ int smem[];
  const int nbins = bound + 1;
  int* hist = smem;
  int* red = smem + nbins;
  int* flag = red + kHistFlag;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = static_cast<int>(blockIdx.x) / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const typename P::Row R = p.row(r);
  for (int k = tid; k < nbins; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  const int share = (width + cs - 1) / cs;
  const int lo = min(width, rank * share);
  const int hi = min(width, lo + share);
  constexpr int kUnroll = 4;  // loads in flight per thread before the binning
  for (int base = lo; base < hi; base += kUnroll * blockDim.x) {  // uniform trip count
    int key[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * static_cast<int>(blockDim.x) + tid;
      int nb;
      key[u] = (j < hi) ? min(max(p.slot(R, j, nb), 0), bound) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // Equal bins of a warp add once: hub rows repeat low estimates, and
      // same-address shared atomics serialise.
      const unsigned peers = __match_any_sync(kFullMask, key[u]);
      if (key[u] > 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[key[u]], __popc(peers));
    }
  }
  if (cs > 1) {
    cluster.sync();  // every block's bins are complete and visible to the cluster
    int* lead = cluster.map_shared_rank(hist, 0);
    const int per = (nbins + cs - 1) / cs;
    const int k1 = min(nbins, (rank + 1) * per);
    for (int k = rank * per + tid; k < k1; k += blockDim.x) {
      int s = 0;
      for (int q = 0; q < cs; ++q) s += cluster.map_shared_rank(hist, q)[k];
      lead[k] = s;  // only this rank reads or writes bin k of the leader now
    }
    cluster.sync();
  } else {
    __syncthreads();
  }
  if (rank == 0) {
    const int h = hist_hindex(hist, nbins, red);
    const int push = p.finish(r, R, h, tid == 0) ? 1 : 0;
    if (cs == 1) {
      if (tid == 0) *flag = push;
    } else if (tid < cs) {
      *cluster.map_shared_rank(flag, tid) = push;
    }
  }
  // Also keeps every block's shared memory alive until the leader is done
  // with it.
  if (cs > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  if (*flag) {
    for (int j = lo + tid; j < hi; j += blockDim.x) p.push(p.neighbor(R, j));
  }
}

}  // namespace kcore
