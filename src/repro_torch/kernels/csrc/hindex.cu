// h-index kernel over pre-gathered neighbour estimates (engine="kernel").
//
// Replaces the Pallas TPU kernel src/repro/kernels/hindex/hindex.py
// (_hindex_kernel, launched by hindex_pallas): per row,
//     out[r] = ext[r] + max{ i in [1, min(cand, width)] : #{x[r, j] >= ext[r] + i} >= i }
// (0 if no i is feasible) over x [rows, width] int32 with -1 padding.
//
// What bounds it on the H100: bytes. Each row is read once from HBM
// (4 * width bytes) and the answer written once; the search does about
// width * log2(cand) int32 compares on the CUDA cores, under one compare
// per byte read, far below the ~5 ops/byte at which the INT32 rate
// (16.7 Tops/s) would take over from the 3.35 TB/s memory rate.
//
// What the design does about it: the TPU form's [tile, width, cand_chunk]
// compare volume (O(width * cand)) becomes a binary search over the exact
// count, so compute stays out of the way; each row is read once, with
// coalesced loads (a warp or block per row above width 16), and the row's
// values stay in registers for the search below width 1024. Rows wider
// than 1024 re-read their row from L1/L2 on each counting pass, which
// costs cache bandwidth, not HBM bytes. See hindex_common.cuh.
#include "hindex_common.cuh"

namespace {

struct HindexPolicy {
  const int32_t* __restrict__ x;
  const int32_t* __restrict__ ext;
  int32_t* __restrict__ out;
  int width;

  struct Row {
    int e;
    int64_t base;
  };

  __device__ __forceinline__ Row row(int r) const {
    return Row{__ldg(ext + r), static_cast<int64_t>(r) * width};
  }
  __device__ __forceinline__ int slot(const Row& R, int j, int& nb) const {
    nb = 0;
    return __ldg(x + R.base + j) - R.e;
  }
  __device__ __forceinline__ int neighbor(const Row&, int) const { return 0; }
  __device__ __forceinline__ bool finish(int r, const Row& R, int h, bool write) const {
    if (write) out[r] = R.e + h;
    return false;
  }
  __device__ __forceinline__ void push(int) const {}
};

}  // namespace

// x [rows, width] int32 (-1 pad), ext [rows] int32 -> out [rows] int32.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int kcore_hindex(const int32_t* x, const int32_t* ext, int32_t* out,
                            int rows, int width, int cand, void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  const int bound = min(max(cand, 1), width);
  const HindexPolicy p{x, ext, out, width};
  kcore::dispatch(p, rows, width, bound, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
