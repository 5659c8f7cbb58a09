// h-index kernel over pre-gathered neighbour estimates (engine="kernel").
//
// Replaces the Pallas TPU kernel src/repro/kernels/hindex/hindex.py
// (_hindex_kernel, launched by hindex_pallas): per row,
//     out[r] = ext[r] + max{ i in [1, min(cand, width)] : #{x[r, j] >= ext[r] + i} >= i }
// (0 if no i is feasible) over x [rows, width] int32 with -1 padding.
//
// What bounds it on the H100: bytes. Each row is read once from HBM
// (4 * width bytes) and the answer written once; the arithmetic is far
// below the ~5 int32 operations per byte at which the INT32 rate
// (16.7 Tops/s) would take over from the 3.35 TB/s memory rate.
//
// What the design does about it: it is the fused kernel (fused.cu) without
// the gather and the push, on the same paths and the same launch plan
// (kernels/plan.py::fused_launch_plan, launched by hist_common.cuh
// launch_row_plan):
//   * width <= 16: a group of 8 or 16 lanes per row, one slot per lane, so
//     a warp's loads of consecutive rows are contiguous (row_per_group);
//   * width <= 1024: a warp per row, values in registers, binary search
//     (hindex_common.cuh row_per_warp);
//   * wider: one shared-memory histogram of the clamped values per row, so
//     each slot is read once (row_per_cluster), the row split over a
//     thread-block cluster when the tile has fewer rows than SMs;
//   * a bound whose bins exceed shared memory: the exact binary search of
//     hindex_common.cuh row_per_block, which re-reads the row per pass.
// The policy below meets the row-policy contract of those paths: finish()
// writes the estimate and returns false, so nothing is pushed.
#include "hist_common.cuh"

namespace {

struct HindexPolicy {
  // Plain shared atomics on the hist path (hist_common.cuh bin_slots).
  static constexpr bool kAggregateBins = false;
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
// path / threads / blocks / cluster / smem_bytes / group are the launch
// plan of kernels/plan.py::fused_launch_plan for these shapes. Launches on
// `stream`; returns the launch's error, else cudaGetLastError() after it.
extern "C" int kcore_hindex(const int32_t* x, const int32_t* ext, int32_t* out,
                            int rows, int width, int cand, int path, int threads,
                            int blocks, int cluster, int smem_bytes, int group,
                            void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  const int bound = min(max(cand, 1), width);
  const HindexPolicy p{x, ext, out, width};
  const cudaError_t err =
      kcore::launch_row_plan(p, rows, width, bound, path, threads, blocks, cluster,
                             smem_bytes, group, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
