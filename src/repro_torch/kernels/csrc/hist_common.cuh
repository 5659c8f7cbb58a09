// One-pass row paths for Hopper, and the launcher of the two h-index
// kernels (fused.cu, hindex.cu).
//
//   * row_per_group:   a sub-warp group of 8 or 16 lanes per row of at most
//                      16 slots, one slot per lane, ranked by shuffles;
//   * row_per_cluster: a shared-memory histogram of the clamped values per
//                      wider row, each slot read once, the row split over a
//                      thread-block cluster when the tile has too few rows
//                      to fill the card (bins reduced into the leader block
//                      through distributed shared memory).
//
// Both compute the clamped h-index of hindex_common.cuh,
//
//     h(r) = max{ i in [0, B] : #{ j : y[r, j] >= i } >= i },  B = bound,
//
// against the same row policy P (row / slot / neighbor / finish / push),
// but read each slot once where the binary search of hindex_common.cuh
// reads it once per pass. launch_row_plan() launches one bucket by the plan
// of kernels/plan.py::fused_launch_plan: group / warp (hindex_common.cuh
// row_per_warp) / hist (row_per_cluster) / search (hindex_common.cuh
// row_per_block, for a bound whose bins exceed shared memory). bin_slots()
// and cluster_sum_to_leader() are shared with the partial-counts kernel
// (counts.cu), whose rows are histograms of the same kind.
#pragma once

#include <cooperative_groups.h>

#include "hindex_common.cuh"

namespace kcore {

constexpr int kGroupBlock = 128;     // sub-warp path: threads per block
constexpr int kHistMaxThreads = 1024;
constexpr int kHistScratch = 64;     // ints after the bins: 33 reduction slots, the push flag
constexpr int kHistFlag = 40;        // offset of the push flag in the scratch ints

// Bins the slots j in [lo, hi) of a row, taken by `tid` stepping by
// `stride` (a block, or one warp): a key k = key(j) >= 1 adds one to
// bins[k - 1]; keys <= 0 are not counted. With kAggregate, equal keys of a
// warp add once (__match_any_sync), as the fused kernel has done since it
// adopted this path; without, every key is a shared atomic of its own. On
// the H100 the plain atomics were faster for the h-index and counts kernels
// at every wide tile of rmat(20, 16), even on rows whose every slot falls
// in one bin: Hopper's shared atomics absorb same-address adds better than
// __match_any_sync costs. Every lane of each warp must call it with the same
// lo, hi and stride: the trip count is uniform, so __match_any_sync sees
// the whole warp.
template <bool kAggregate, class Key>
__device__ __forceinline__ void bin_slots(int* bins, int lo, int hi, int tid, int stride,
                                          Key key) {
  constexpr int kUnroll = 4;  // loads in flight per thread before the binning
  for (int base = lo; base < hi; base += kUnroll * stride) {
    int k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * stride + tid;
      k[u] = (j < hi) ? key(j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if constexpr (kAggregate) {
        const unsigned peers = __match_any_sync(kFullMask, k[u]);
        const int lane = threadIdx.x & 31;
        if (k[u] > 0 && lane == __ffs(peers) - 1) atomicAdd(&bins[k[u] - 1], __popc(peers));
      } else if (k[u] > 0) {
        atomicAdd(&bins[k[u] - 1], 1);
      }
    }
  }
}

// hist[0, nbins) of the cluster's leader (rank 0) <- the sum of every
// block's hist[0, nbins), through distributed shared memory; rank q sums
// its share of the bins. Called by every thread of every block of the
// cluster; on return the leader's bins are complete and every block may
// reuse its own.
__device__ __forceinline__ void cluster_sum_to_leader(
    cooperative_groups::cluster_group& cluster, int* hist, int nbins) {
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();  // every block's bins are complete and visible to the cluster
  int* lead = cluster.map_shared_rank(hist, 0);
  const int per = (nbins + cs - 1) / cs;
  const int k1 = min(nbins, (rank + 1) * per);
  for (int k = rank * per + static_cast<int>(threadIdx.x); k < k1;
       k += static_cast<int>(blockDim.x)) {
    int s = 0;
    for (int q = 0; q < cs; ++q) s += cluster.map_shared_rank(hist, q)[k];
    lead[k] = s;  // only this rank reads or writes bin k of the leader now
  }
  cluster.sync();
}

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
  const typename P::Row R = p.row(r);
  for (int k = tid; k < nbins; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  const int share = (width + cs - 1) / cs;
  const int lo = min(width, rank * share);
  const int hi = min(width, lo + share);
  bin_slots<P::kAggregateBins>(hist + 1, lo, hi, tid, static_cast<int>(blockDim.x), [&](int j) {
    int nb;
    return min(max(p.slot(R, j, nb), 0), bound);
  });
  if (cs > 1) {
    cluster_sum_to_leader(cluster, hist, nbins);
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

// Launches `kernel` with a cluster dimension of `cluster` blocks and
// `smem_bytes` of dynamic shared memory (opting in above the default 48 KB).
// Returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_ex(void (*kernel)(Params...), int blocks, int threads, int cluster,
                      int smem_bytes, cudaStream_t s, Args... args) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The paths of kernels/plan.py::fused_launch_plan, in the order of its PATHS.
enum Path { kGroup = 0, kWarp = 1, kHist = 2, kSearch = 3 };

template <class P>
void launch_warp(const P& p, int rows, int width, int bound, int blocks, int threads,
                 cudaStream_t s) {
  const int vpt = (width + 31) / 32;
  if (vpt <= 1) {
    row_per_warp<1, P><<<blocks, threads, 0, s>>>(p, rows, width, bound);
  } else if (vpt <= 2) {
    row_per_warp<2, P><<<blocks, threads, 0, s>>>(p, rows, width, bound);
  } else if (vpt <= 4) {
    row_per_warp<4, P><<<blocks, threads, 0, s>>>(p, rows, width, bound);
  } else if (vpt <= 8) {
    row_per_warp<8, P><<<blocks, threads, 0, s>>>(p, rows, width, bound);
  } else if (vpt <= 16) {
    row_per_warp<16, P><<<blocks, threads, 0, s>>>(p, rows, width, bound);
  } else {
    row_per_warp<32, P><<<blocks, threads, 0, s>>>(p, rows, width, bound);
  }
}

// Launches one bucket of rows (rows > 0, 1 <= bound <= width) by the plan
// path / threads / blocks / cluster / smem_bytes / group of
// fused_launch_plan for these shapes. Returns the launch's error (a plan
// that does not fit the width: cudaErrorInvalidValue).
template <class P>
cudaError_t launch_row_plan(const P& p, int rows, int width, int bound, int path,
                            int threads, int blocks, int cluster, int smem_bytes, int group,
                            cudaStream_t s) {
  switch (path) {
    case kGroup:
      if (group == 8 && width <= 8) {
        row_per_group<8, P><<<blocks, threads, 0, s>>>(p, rows, width, bound);
      } else if (group == 16 && width <= 16) {
        row_per_group<16, P><<<blocks, threads, 0, s>>>(p, rows, width, bound);
      } else {
        return cudaErrorInvalidValue;
      }
      return cudaSuccess;
    case kWarp:
      if (width > kWarpMaxWidth) return cudaErrorInvalidValue;
      launch_warp(p, rows, width, bound, blocks, threads, s);
      return cudaSuccess;
    case kHist:
      if (smem_bytes < (bound + 1 + kHistScratch) * 4) return cudaErrorInvalidValue;
      return launch_ex(row_per_cluster<P>, blocks, threads, cluster, smem_bytes, s, p, rows,
                       width, bound);
    case kSearch:
      row_per_block<P><<<blocks, threads, 0, s>>>(p, rows, width, bound);
      return cudaSuccess;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace kcore
