// Scan-lowering probe for Hopper (sm_90a): a row-wide prefix-max scan,
// the query-gap scan of the TPU tile DP, timed alone in two lowerings.
//
// Replaces: tools/scanshift_probe.py, the pallas_call in `one` (line 97;
// kernel at :76-85), which times the DP's in-row shift-max scan lowered
// two ways on the TPU (concat-shift and roll+mask).  What it computes,
// for each row of x [B, C] int32: STEPS chained scans
//   u = x;  for s in 0..STEPS-1:  u = inclusive_prefix_max(u + s)
// and writes u.  Its plain version is torch.cummax
// (darwin_tpu_torch/ops/scanshift.py::scanshift_torch).
//
// What bounds it on the H100: latency.  One row is C <= 1024 ints; the
// STEPS scans of a row are a dependent chain of barrier-separated steps,
// and B rows give B independent blocks.  Bytes (8 per element) are
// negligible.
//
// The two lowerings, one block a row, one thread a column:
//  (shfl) block_inclusive_max below: warp shuffles, then a per-warp
//         carry through shared memory; two barriers a scan.
//  (smem) a Hillis-Steele scan in shared memory: ceil(log2 C) steps of
//         max(v[t], v[t-d]), d = 1, 2, 4, ..., ping-ponging between two
//         buffers with one barrier a step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Block-wide inclusive prefix max of one value a thread, thread t holding
// column t: each warp scans its 32 columns with shuffles (5 dependent
// steps); lane 31 publishes the warp's total to shared memory, one
// barrier, and every thread folds in the totals of the warps before its
// own (the per-warp carry).  sh_wmax: 32 ints; the caller needs another
// barrier between this call's return and the next write to sh_wmax.
__device__ __forceinline__ int block_inclusive_max(int v, int lane, int warp,
                                                   int* sh_wmax) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(kFullMask, v, s);
    if (lane >= s) v = max(v, o);
  }
  if (lane == 31) sh_wmax[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v = max(v, sh_wmax[w]);
  return v;
}

__global__ void scan_shfl_kernel(const int* __restrict__ x, int C,
                                 int steps, int* __restrict__ out) {
  __shared__ int sh_wmax[32];
  const int t = threadIdx.x;
  const size_t at = static_cast<size_t>(blockIdx.x) * C + t;
  // Threads past C sit after every real column; their values never
  // reach a real column's prefix.
  int v = t < C ? x[at] : 0;
  for (int s = 0; s < steps; ++s) {
    v = block_inclusive_max(v + s, t & 31, t >> 5, sh_wmax);
    __syncthreads();
  }
  if (t < C) out[at] = v;
}

__global__ void scan_smem_kernel(const int* __restrict__ x, int C,
                                 int steps, int* __restrict__ out) {
  extern __shared__ int buf[];  // [2][blockDim.x]
  const int n = blockDim.x;
  const int t = threadIdx.x;
  const size_t at = static_cast<size_t>(blockIdx.x) * C + t;
  int v = t < C ? x[at] : 0;
  for (int s = 0; s < steps; ++s) {
    int* cur = buf;
    int* nxt = buf + n;
    cur[t] = v + s;
    __syncthreads();
    for (int d = 1; d < n; d <<= 1) {
      int w = cur[t];
      if (t >= d) w = max(w, cur[t - d]);
      nxt[t] = w;
      __syncthreads();
      int* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    // Only this thread's own slot is touched before the next barrier.
    v = cur[t];
  }
  if (t < C) out[at] = v;
}

}  // namespace

// lowering: 0 shfl, 1 smem.  x, out: [B, C] int32, 1 <= C <= 1024.
extern "C" int dtt_scanshift(const int* x, int B, int C, int steps,
                             int lowering, int* out, void* stream) {
  if (C < 1 || C > 1024 || (lowering != 0 && lowering != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (C + 31) / 32 * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lowering == 0) {
    scan_shfl_kernel<<<B, threads, 0, s>>>(x, C, steps, out);
  } else {
    scan_smem_kernel<<<B, threads, 2 * threads * sizeof(int), s>>>(
        x, C, steps, out);
  }
  return static_cast<int>(cudaGetLastError());
}
