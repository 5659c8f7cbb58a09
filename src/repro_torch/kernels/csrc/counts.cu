// Partial suffix counts of one slot shard (the distributed engine's psum
// payload).
//
// Replaces the Pallas TPU kernel src/repro/kernels/counts/counts.py
// (_counts_kernel, launched by partial_counts_pallas): per row r of the
// LOCAL slot shard x [rows, width] int32 (-1 pad) and i in [0, cand),
//     out[r, i] = #{j : x[r, j] >= ext[r] + i + 1}
// -- an int32 [rows, cand] matrix that the engine sums over the slot shards
// before its feasibility argmax.
//
// What bounds it on the H100: bytes, and almost all of them the output. A
// full sweep of rmat(20, 16) writes rows * cand * 4 = 3.59 GB against 184 MB
// of gathered input (one read of each slot), so the bound is
// (rows*width*4 + rows*4 + rows*cand*4) / 3.35 TB/s, about 1.1 ms.
//
// What the design does about it: the TPU form compares every slot with every
// candidate (rows x width x cand compares, tiled through VMEM). Here one
// block takes one row: it builds a histogram of v = x - ext in shared memory
// (shared atomics, v clamped to the window's top bin, so a slot is read once
// and compared once), turns it into suffix counts with a block scan, and
// writes the row's cand counts with coalesced stores -- the one pass over
// the bytes that bound it. A window holds up to kWindow bins; a larger cand
// is done window by window, each re-reading the row (the output still
// dominates: cand > kWindow means more than 32 KB written per row).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 8192;  // histogram bins in shared memory at once (32 KB)

__global__ void __launch_bounds__(kThreads)
partial_counts_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ ext,
                      int32_t* __restrict__ out, int width, int cand) {
  extern __shared__ int hist[];
  __shared__ int warp_sums[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* row = x + static_cast<int64_t>(blockIdx.x) * width;
  int32_t* orow = out + static_cast<int64_t>(blockIdx.x) * cand;
  const long long e = __ldg(ext + blockIdx.x);
  for (int lo = 0; lo < cand; lo += kWindow) {
    // Candidates i in [lo, hi) of this window: bin k counts slots with
    // v == lo + k + 1, the last bin every v >= hi.
    const int nb = min(kWindow, cand - lo);
    const int hi = lo + nb;
    for (int k = tid; k < nb; k += kThreads) hist[k] = 0;
    __syncthreads();
    int above = 0;  // slots at or above the window's top, added once per thread
    for (int j = tid; j < width; j += kThreads) {
      const long long v = static_cast<long long>(__ldg(row + j)) - e;
      if (v >= hi) {
        ++above;
      } else if (v > lo) {
        atomicAdd(&hist[static_cast<int>(v - lo - 1)], 1);
      }
    }
    if (above) atomicAdd(&hist[nb - 1], above);
    __syncthreads();
    // Suffix scan, hist[k] <- sum of hist[k'] for k' >= k: each thread sums
    // a contiguous run of bins, the runs' suffix sums come from a warp
    // shuffle scan plus the later warps' totals, then each thread rewrites
    // its run from the top down.
    const int per = (nb + kThreads - 1) / kThreads;
    const int k0 = min(tid * per, nb), k1 = min(k0 + per, nb);
    int local = 0;
    for (int k = k0; k < k1; ++k) local += hist[k];
    int incl = local;  // sum of `local` over lanes >= this lane
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += y;
    }
    if (lane == 0) warp_sums[warp] = incl;
    __syncthreads();
    int run = incl - local;
    for (int w = warp + 1; w < kWarps; ++w) run += warp_sums[w];
    for (int k = k1 - 1; k >= k0; --k) {
      run += hist[k];
      hist[k] = run;
    }
    __syncthreads();
    for (int k = tid; k < nb; k += kThreads) orow[lo + k] = hist[k];
    __syncthreads();
  }
}

}  // namespace

// x [rows, width] int32 (-1 pad), ext [rows] int32 -> out [rows, cand] int32.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int kcore_partial_counts(const int32_t* x, const int32_t* ext, int32_t* out,
                                    int rows, int width, int cand, void* stream) {
  if (rows <= 0 || cand <= 0) return 0;
  const size_t smem = sizeof(int) * static_cast<size_t>(cand < kWindow ? cand : kWindow);
  partial_counts_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, ext, out, width, cand);
  return static_cast<int>(cudaGetLastError());
}
