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
// What bounds it on the H100: bytes, and above all the gather. The tile
// (4 * width bytes a row) is read once and coalesced, but each neighbour
// estimate is a random 2- or 4-byte read of c, which costs a 32-byte
// sector whenever it misses L2. The int32 compares (about
// width * log2(cand) a row) are far below the INT32 rate.
//
// What the design does about it: one launch does everything the reference
// does in separate dispatches, with no gathered [rows, width] matrix in
// HBM; an int16 c halves the gathered bytes and is widened in registers;
// rows are dispatched by width class (thread / warp / block per row, see
// hindex_common.cuh) so hub rows do not stall the narrow ones. Rows up to
// width 1024 are read and gathered once and keep their neighbour ids for
// the push in registers. Rows wider than 1024 (the block path) are not:
// they re-read the row and re-gather c on each of the ~log2(cand) search
// passes and read the neighbour ids again for the push, from L1/L2 while
// the row fits there. A shared-memory histogram for these rows is queued
// in ROADMAP.md. The dirty push is an idempotent byte store
// of 1, so it needs no atomics; the caller zeroes `dirty` before the first
// launch of a sweep (CUDA blocks have no order in which one could zero it),
// and pushes to the sentinel slot n are skipped (that slot is never read).
#include "hindex_common.cuh"

namespace {

template <typename T>
struct FusedPolicy {
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
  __device__ __forceinline__ void push(int nb) const {
    if (nb != sentinel) dirty[nb] = 1;
  }
};

template <typename T>
void launch(const void* c, const int32_t* ext_pad, const int32_t* ids,
            const int32_t* neigh, int32_t* est, int32_t* changed, int8_t* dirty,
            int rows, int width, int bound, int sentinel, bool track_dirty,
            cudaStream_t stream) {
  const FusedPolicy<T> p{static_cast<const T*>(c), ext_pad, ids, neigh, est,
                         changed, dirty, width, sentinel, track_dirty};
  kcore::dispatch(p, rows, width, bound, stream);
}

}  // namespace

// c [n+1] int16 (c_bytes 2) or int32 (c_bytes 4), slot n = -1;
// ext_pad [n+1] int32; ids [rows] int32; neigh [rows, width] int32 (pads
// = n); outputs est, changed [rows] int32; dirty [n+1] int8 (stored into,
// not zeroed). Launches on `stream`; returns cudaGetLastError() after it.
extern "C" int kcore_fused_sweep(const void* c, int c_bytes, const int32_t* ext_pad,
                                 const int32_t* ids, const int32_t* neigh,
                                 int32_t* est, int32_t* changed, int8_t* dirty,
                                 int n, int rows, int width, int cand,
                                 int track_dirty, void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  const int bound = min(max(cand, 1), width);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_bytes == 2) {
    launch<int16_t>(c, ext_pad, ids, neigh, est, changed, dirty, rows, width,
                    bound, n, track_dirty != 0, s);
  } else {
    launch<int32_t>(c, ext_pad, ids, neigh, est, changed, dirty, rows, width,
                    bound, n, track_dirty != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
