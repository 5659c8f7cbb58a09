// Partial suffix counts of one slot shard (the distributed engine's psum
// payload).
//
// Replaces the Pallas TPU kernel src/repro/kernels/counts/counts.py
// (_counts_kernel, launched by partial_counts_pallas): per row r of the
// LOCAL slot shard x [rows, width] int32 (-1 pad) and i in [0, cand),
//     out[r, i] = #{j : x[r, j] >= ext[r] + i + 1}
// -- an int32 [rows, cand] matrix that the engine sums over the slot shards
// before its feasibility argmax. cand is not clamped to the width.
//
// What bounds it on the H100: bytes, and almost all of them the output. A
// full sweep of rmat(20, 16) writes rows * cand * 4 = 3.59 GB against 184 MB
// of gathered input (one read of each slot), so the bound is
// (rows*width*4 + rows*4 + rows*cand*4) / 3.35 TB/s, about 1.1 ms. So the
// design streams the output at the write rate, with no barrier of a whole
// block per row, and spends a few integer operations per int written: the
// INT32 rate (16.7 Tops/s) would take over from the memory rate only at
// about 5 operations per byte. With v = clamp(x - ext, 0, cand), a row's
// counts are #{j : v_j > i}. The path is chosen by the width, in the launch
// plan of kernels/counts/ops.py::counts_launch_plan (this file only
// launches the plan it is given):
//   * step (width <= 16, most of the output): a row's counts are a
//     non-increasing step function of i with at most 16 steps. A block
//     stages a run of rows: G = 8 or 16 lanes rank one row's values by
//     shuffles and store them in order in shared memory. The block's rows
//     are then one contiguous span of the flat output, written with 16-byte
//     stores (a scalar head and tail: a row start is not 16-byte aligned
//     when cand is odd); a count is G minus the number of the row's sorted
//     values at or below i, which each lane walks up as its i grows.
//   * warp (width <= 1024): a warp per row, with a warp-private histogram of
//     cand bins in shared memory (plain shared atomics, hist_common.cuh
//     bin_slots); the warp suffix-scans 4 bins a lane and writes the
//     row with 16-byte stores (the bins sit shifted so that their int4s
//     match the output's aligned int4s). Only __syncwarp, never a block
//     barrier per row.
//   * hist (wider rows, or a cand whose bins do not fit the warp path): a
//     block per row with a shared-memory histogram of up to MAX_BINS bins, a
//     tile with fewer rows than SMs splitting each row over a thread-block
//     cluster whose bins are summed into the leader block through
//     distributed shared memory; the leader suffix-scans and writes the row.
//     A cand above the window is done window by window, each re-reading the
//     row (the output still dominates: more than 224 KB a row).
// Every flat output index is computed in 64 bits: one tile's rows * cand
// can pass 2^31. The counts are written with streaming stores (__stcs,
// evict-first): the matrix never fits in the 50 MB L2, and on the H100
// they took 3% off a full sweep against plain stores.
#include <climits>

#include "hist_common.cuh"

namespace {

using kcore::bin_slots;
using kcore::cluster_sum_to_leader;
using kcore::kFullMask;

constexpr int kStepBlock = 256;  // step path: threads per block
constexpr int kWarpBlock = 256;  // warp path: 8 warps, one row each
constexpr int kHistMaxBlock = 1024;

// The paths of kernels/counts/ops.py::counts_launch_plan, in the order of
// its COUNTS_PATHS.
enum CountsPath { kStep = 0, kWarp = 1, kHist = 2 };

// min(x - e, cap) if that is at least 1, else 0 (a pad slot holds -1 and
// e >= 0, so it gives 0). In 64 bits: x - e may leave int32 either way.
__device__ __forceinline__ int clamped(int32_t x, int32_t e, int cap) {
  const long long v = static_cast<long long>(x) - e;
  return v < 1 ? 0 : static_cast<int>(min(v, static_cast<long long>(cap)));
}

// #{k : a[k] <= i} over G values sorted ascending (G a power of two).
template <int G>
__device__ __forceinline__ int rank_le(const int* a, int i) {
  int p = 0;
#pragma unroll
  for (int s = G / 2; s >= 1; s >>= 1) p += (a[p + s - 1] <= i) ? s : 0;
  return p + ((a[p] <= i) ? 1 : 0);
}

// Count of local flat offset f of a block's span: row f / cand, candidate
// f % cand (for the few scalar head and tail elements).
template <int G>
__device__ __forceinline__ int step_count(const int* sorted, int64_t f, int cand) {
  const int rl = static_cast<int>(f / cand);
  const int i = static_cast<int>(f - static_cast<int64_t>(rl) * cand);
  return G - rank_le<G>(sorted + rl * G, i);
}

// Narrow rows (width <= G): see the file comment. rows_per_block is a
// multiple of kStepBlock / G; dynamic shared memory holds its rows' G
// sorted values each.
template <int G>
__global__ void __launch_bounds__(kStepBlock)
counts_step(const int32_t* __restrict__ x, const int32_t* __restrict__ ext,
            int32_t* __restrict__ out, int rows, int width, int cand, int rows_per_block) {
  extern __shared__ int sorted[];
  const int tid = threadIdx.x;
  const int row0 = static_cast<int>(blockIdx.x) * rows_per_block;
  const int nrows = min(rows_per_block, rows - row0);
  // Stage: the G lanes of a row rank its values (stable: ties by lane) and
  // store each at its rank. Every lane runs the same number of rounds, so
  // whole warps shuffle.
  const int j = tid & (G - 1);
  for (int rl = tid / G; rl < rows_per_block; rl += kStepBlock / G) {
    int a = 0;
    if (rl < nrows && j < width) {
      const int r = row0 + rl;
      a = clamped(__ldg(x + static_cast<int64_t>(r) * width + j), __ldg(ext + r), cand);
    }
    int rank = 0;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int b = __shfl_sync(kFullMask, a, k, G);
      rank += (b < a || (b == a && k < j)) ? 1 : 0;
    }
    sorted[rl * G + rank] = a;
  }
  __syncthreads();
  // Write the block's span [s0, s0 + span) of the flat output: a scalar head
  // up to the first 16-byte boundary, int4 vectors, a scalar tail.
  const int64_t s0 = static_cast<int64_t>(row0) * cand;
  const int64_t span = static_cast<int64_t>(nrows) * cand;
  int head = (4 - static_cast<int>(s0 & 3)) & 3;
  if (head > span) head = static_cast<int>(span);
  const int64_t nvec = (span - head) >> 2;
  const int tail = static_cast<int>(span - head - 4 * nvec);
  if (tid < head) __stcs(out + s0 + tid, step_count<G>(sorted, tid, cand));
  if (tid < tail) {
    const int64_t f = span - tail + tid;
    __stcs(out + s0 + f, step_count<G>(sorted, f, cand));
  }
  // Warp w writes a contiguous run of the span's vectors, 32 consecutive
  // vectors a step, so lane l's position (rl, i) moves 128 counts a step
  // (by a constant, with no division) and mostly stays in its row. Its
  // count G - p walks p = #{a <= i} up the row's sorted values: a compare a
  // count, and each value passed once a lane. A vector that runs into the
  // next row(s) searches each of its counts instead.
  constexpr int kWarps = kStepBlock / 32;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t per_warp = ((nvec + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int64_t vbeg = warp * per_warp;
  const int64_t vend = (vbeg + per_warp < nvec) ? vbeg + per_warp : nvec;
  const int dq = 128 / cand;
  const int dr = 128 - dq * cand;
  const int64_t f0 = head + 4 * (vbeg + lane);
  int rl = static_cast<int>(f0 / cand);
  int i = static_cast<int>(f0 - static_cast<int64_t>(rl) * cand);
  const int* a = sorted + rl * G;
  int p = -1;  // with nxt = -1: a virtual a[-1] below every i, so the walk starts at a[0]
  int nxt = -1;
  int4* dst = reinterpret_cast<int4*>(out + s0 + head) + vbeg + lane;
  for (int64_t v = vbeg + lane; v < vend; v += 32) {
    int e[4];
    if (i + 3 < cand) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        while (nxt <= i + u) {
          ++p;
          nxt = (p < G) ? a[p] : INT_MAX;
        }
        e[u] = G - p;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int r2 = rl;
        int i2 = i + u;
        while (i2 >= cand) {
          i2 -= cand;
          ++r2;
        }
        e[u] = G - rank_le<G>(sorted + r2 * G, i2);
      }
    }
    __stcs(dst, make_int4(e[0], e[1], e[2], e[3]));
    dst += 32;
    const int rl0 = rl;
    rl += dq;
    i += dr;
    if (i >= cand) {
      i -= cand;
      ++rl;
    }
    if (rl != rl0) {
      a = sorted + rl * G;
      p = -1;
      nxt = -1;
    }
  }
}

// Rows of up to 1,024 slots: a warp per row, see the file comment. Each
// warp's histogram takes `stride` ints of dynamic shared memory (a multiple
// of 4, at least cand + 3): candidate i sits at hist[off + i], off = (r *
// cand) % 4, so hist's int4 k maps onto the output's aligned int4 at flat
// index r * cand - off + 4k.
__global__ void __launch_bounds__(kWarpBlock)
counts_warp(const int32_t* __restrict__ x, const int32_t* __restrict__ ext,
            int32_t* __restrict__ out, int rows, int width, int cand, int stride) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r64 = static_cast<int64_t>(blockIdx.x) * (kWarpBlock / 32) + warp;
  if (r64 >= rows) return;  // uniform across the warp; no block barrier follows
  const int r = static_cast<int>(r64);
  int* hist = reinterpret_cast<int*>(smem4) + warp * stride;
  int4* hist4 = reinterpret_cast<int4*>(hist);
  const int n4 = stride / 4;
  const int64_t base = r64 * cand;  // flat index of out[r, 0]
  const int off = static_cast<int>(base & 3);
  for (int k = lane; k < n4; k += 32) hist4[k] = make_int4(0, 0, 0, 0);
  __syncwarp();
  const int e = __ldg(ext + r);
  const int32_t* row = x + r64 * width;
  bin_slots<false>(hist + off, 0, width, lane, 32,
                   [&](int j) { return clamped(__ldg(row + j), e, cand); });
  __syncwarp();
  // Suffix sums from the top, 32 int4s a step: within a lane's int4, then
  // across the lanes by shuffles, plus the carry of the steps above.
  int32_t* const aligned = out + (base - off);
  const int last = off + cand;  // hist[off, last) are the row's candidates
  int carry = 0;
  for (int top = ((n4 + 31) / 32 - 1) * 32; top >= 0; top -= 32) {
    const int k = top + lane;
    int4 h = (k < n4) ? hist4[k] : make_int4(0, 0, 0, 0);
    h.z += h.w;
    h.y += h.z;
    h.x += h.y;
    int incl = h.x;  // becomes the sum over this lane's and the later lanes' int4s
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(kFullMask, incl, o);
      if (lane + o < 32) incl += y;
    }
    const int above = carry + incl - h.x;
    h.x += above;
    h.y += above;
    h.z += above;
    h.w += above;
    carry += __shfl_sync(kFullMask, incl, 0);
    const int q = 4 * k;
    if (q >= off && q + 4 <= last) {
      __stcs(reinterpret_cast<int4*>(aligned + q), h);
    } else if (q < last && q + 4 > off) {  // the row's first or last int4
      const int hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q + u >= off && q + u < last) __stcs(aligned + q + u, hv[u]);
      }
    }
  }
}

// Wide rows: a block per row, or a cluster of cs blocks per row (the blocks
// of row r are r * cs ... r * cs + cs - 1, in cluster-rank order), each
// binning its share of the slots. Window by window of `window` candidates
// [lo, hi): bin k counts v == lo + k + 1, the last bin every v >= hi; the
// cluster's bins are summed into the leader, which suffix-scans them and
// writes out[r, lo:hi). Dynamic shared memory: window bins, then
// kHistScratch ints.
__global__ void __launch_bounds__(kHistMaxBlock)
counts_cluster(const int32_t* __restrict__ x, const int32_t* __restrict__ ext,
               int32_t* __restrict__ out, int rows, int width, int cand, int window) {
  namespace cg = cooperative_groups;
  extern __shared__ int smem[];
  int* hist = smem;
  int* red = smem + window;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = static_cast<int>(blockIdx.x) / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = static_cast<int>(blockDim.x >> 5);
  const int e = __ldg(ext + r);
  const int32_t* row = x + static_cast<int64_t>(r) * width;
  int32_t* orow = out + static_cast<int64_t>(r) * cand;
  const int share = (width + cs - 1) / cs;
  const int jlo = min(width, rank * share);
  const int jhi = min(width, jlo + share);
  for (int lo = 0; lo < cand; lo += window) {
    const int nb = min(window, cand - lo);
    const int hi = lo + nb;
    for (int k = tid; k < nb; k += blockDim.x) hist[k] = 0;
    __syncthreads();
    bin_slots<false>(hist, jlo, jhi, tid, static_cast<int>(blockDim.x), [&](int j) {
      const long long v = static_cast<long long>(__ldg(row + j)) - e;
      return v <= lo ? 0 : static_cast<int>(min(v, static_cast<long long>(hi)) - lo);
    });
    if (cs > 1) {
      cluster_sum_to_leader(cluster, hist, nb);
    } else {
      __syncthreads();
    }
    if (rank == 0) {
      // Suffix scan, hist[k] <- sum of hist[k'] for k' >= k: each thread sums
      // a contiguous run of bins, the runs' suffix sums come from a warp
      // shuffle scan plus the later warps' totals, then each thread
      // rewrites its run from the top down.
      const int per = (nb + nwarps * 32 - 1) / (nwarps * 32);
      const int k0 = min(tid * per, nb);
      const int k1 = min(k0 + per, nb);
      int local = 0;
      for (int k = k0; k < k1; ++k) local += hist[k];
      int incl = local;  // sum of `local` over lanes >= this lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_down_sync(kFullMask, incl, o);
        if (lane + o < 32) incl += y;
      }
      if (lane == 0) red[warp] = incl;
      __syncthreads();
      int run = incl - local;
      for (int w = warp + 1; w < nwarps; ++w) run += red[w];
      for (int k = k1 - 1; k >= k0; --k) {
        run += hist[k];
        hist[k] = run;
      }
      __syncthreads();
      for (int k = tid; k < nb; k += blockDim.x) __stcs(orow + lo + k, hist[k]);
    }
    __syncthreads();  // hist and red are reused by the next window
  }
}

cudaError_t launch(const int32_t* x, const int32_t* ext, int32_t* out, int rows, int width,
                   int cand, int path, int threads, int blocks, int cluster,
                   int smem_bytes, int rows_per_block, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorMisalignedAddress;
  switch (path) {
    case kStep: {
      const int g = width <= 8 ? 8 : 16;
      if (width > 16 || threads != kStepBlock || cluster != 1 ||
          rows_per_block % (kStepBlock / g) != 0 ||
          smem_bytes < rows_per_block * g * 4) {
        return cudaErrorInvalidValue;
      }
      return g == 8 ? kcore::launch_ex(counts_step<8>, blocks, threads, 1, smem_bytes, s, x,
                                       ext, out, rows, width, cand, rows_per_block)
                    : kcore::launch_ex(counts_step<16>, blocks, threads, 1, smem_bytes, s, x,
                                       ext, out, rows, width, cand, rows_per_block);
    }
    case kWarp: {
      const int stride = (cand + 6) / 4 * 4;
      if (width > kcore::kWarpMaxWidth || threads != kWarpBlock || cluster != 1 ||
          smem_bytes < (kWarpBlock / 32) * stride * 4) {
        return cudaErrorInvalidValue;
      }
      return kcore::launch_ex(counts_warp, blocks, threads, 1, smem_bytes, s, x, ext, out,
                              rows, width, cand, stride);
    }
    case kHist: {
      const int window = min(cand, smem_bytes / 4 - kcore::kHistScratch);
      if (window < 1 || threads > kHistMaxBlock) return cudaErrorInvalidValue;
      return kcore::launch_ex(counts_cluster, blocks, threads, cluster, smem_bytes, s, x, ext,
                              out, rows, width, cand, window);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [rows, width] int32 (-1 pad), ext [rows] int32 -> out [rows, cand] int32
// (16-byte aligned). path / threads / blocks / cluster / smem_bytes /
// rows_per_block are the launch plan of kernels/counts/ops.py::
// counts_launch_plan for these shapes. Launches on `stream`; returns the
// launch's error, else cudaGetLastError() after it.
extern "C" int kcore_partial_counts(const int32_t* x, const int32_t* ext, int32_t* out,
                                    int rows, int width, int cand, int path, int threads,
                                    int blocks, int cluster, int smem_bytes,
                                    int rows_per_block, void* stream) {
  if (rows <= 0 || cand <= 0) return 0;
  const cudaError_t err = launch(x, ext, out, rows, width, cand, path, threads, blocks,
                                 cluster, smem_bytes, rows_per_block,
                                 static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
