// Block-wide inclusive prefix max, one value per thread, for N
// independent rows at once: the query-gap scan of the GACT tile DP
// (dp.cu), shared with the scan probe (scanshift.cu, lowering "shfl") so
// that the probe times the DP kernel's own scan.
//
// Thread t holds column t of each row; the scan runs over the threads of
// the block in order.  Each warp scans its 32 columns with shuffles
// (log2 32 = 5 dependent steps), the N rows' steps interleaved so that
// their latencies overlap; lane 31 publishes the warp's total to shared
// memory, one barrier, and every thread folds in the totals of the warps
// before its own (the per-warp carry).
#pragma once

#include <cuda_runtime.h>

namespace dtt {

constexpr unsigned kFullMask = 0xffffffffu;

// v[k]: this thread's value in row k, replaced by its inclusive prefix
// max.  sh_wmax: N * 32 ints of shared memory.  Contains one
// __syncthreads(); the caller needs another barrier between this call's
// return and the next write to sh_wmax.
template <int N>
__device__ __forceinline__ void block_inclusive_max(int (&v)[N], int lane,
                                                    int warp,
                                                    int* sh_wmax) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int o = __shfl_up_sync(kFullMask, v[k], s);
      if (lane >= s) v[k] = max(v[k], o);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < N; ++k) sh_wmax[k * 32 + warp] = v[k];
  }
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = max(v[k], sh_wmax[k * 32 + w]);
  }
}

}  // namespace dtt
