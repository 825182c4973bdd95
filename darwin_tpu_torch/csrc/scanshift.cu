// Scan-lowering probe for Hopper (sm_90a): a row-wide prefix-max scan,
// the query-gap scan of the TPU tile DP, timed alone in two lowerings.
//
// Replaces: tools/scanshift_probe.py, the pallas_call in `one` (line 97;
// kernel at :76-85), which times the DP's in-row shift-max scan lowered
// two ways on the TPU (concat-shift and roll+mask).  What it computes,
// for each row of x [B, C] int32: STEPS chained scans
//   u = x;  for s in 0..STEPS-1:  u = inclusive_prefix_max(u + s)
// (the add wraps as int32) and writes u.  Its plain version is
// torch.cummax (darwin_tpu_torch/ops/scanshift.py::scanshift_torch).
//
// What bounds it on the H100: latency.  Bytes (8 a element) and
// operations (2 an element a scan) are a few microseconds of the card;
// the STEPS scans of a row are one dependent chain.
//
// Design: one warp a row, WARPS rows a block, no block barrier.  Lane l
// holds N = ceil(C / 32) contiguous columns l*N .. l*N+N-1 in registers
// (16-byte loads and stores where C is a multiple of 4 and the tensors
// are 16-byte aligned), so the 16 chained scans never leave registers.
// Each scan: a serial max over the lane's N columns, a scan of the 32
// lane totals, and the carry from the lanes before folded back.  The
// two lowerings differ in the scan of the lane totals:
//  (shfl) five __shfl_up_sync steps;
//  (smem) a Hillis-Steele scan of the 32 totals in shared memory, five
//         steps under __syncwarp.
// Every global access goes through dtt::at.

#include <climits>
#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

using dtt::at;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int WARPS = 8;  // rows a block

// Inclusive prefix max of the lanes' totals t; returns the max of the
// lanes before this one (INT_MIN for lane 0).
template <bool SMEM>
__device__ __forceinline__ int carry_in(int t, int lane, int (*b)[32]) {
  if constexpr (SMEM) {
    b[0][lane] = t;
    __syncwarp();
    int cur = 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int v = b[cur][lane];
      if (lane >= d) v = max(v, b[cur][lane - d]);
      b[cur ^ 1][lane] = v;
      __syncwarp();
      cur ^= 1;
    }
    // b[0] was last read before the last __syncwarp; b[1], read here,
    // is next written after the next call's first __syncwarp.
    return lane ? b[cur][lane - 1] : INT_MIN;
  } else {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t = max(t, o);
    }
    const int c = __shfl_up_sync(kFull, t, 1);
    return lane ? c : INT_MIN;
  }
}

template <int N, bool SMEM>
__global__ void __launch_bounds__(WARPS * 32)
    scan_kernel(const int* x, int B, int C, int steps, bool vec, int* out) {
  __shared__ int sh[SMEM ? WARPS : 1][2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= B) return;  // a whole warp; nothing waits on it
  const size_t r0 = static_cast<size_t>(row) * C;
  const int c0 = lane * N;
  int v[N];
  if constexpr (N % 4 == 0) {
    if (vec) {  // C % 4 == 0: each piece lies wholly inside the row
      const int4* xr = reinterpret_cast<const int4*>(x + r0 + c0);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const int4 a = c0 + 4 * q < C ? at(xr, q)
                                      : make_int4(INT_MIN, INT_MIN, INT_MIN,
                                                  INT_MIN);
        v[4 * q] = a.x;
        v[4 * q + 1] = a.y;
        v[4 * q + 2] = a.z;
        v[4 * q + 3] = a.w;
      }
    }
  }
  if (N % 4 != 0 || !vec) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = c0 + i < C ? at(x, r0 + c0 + i) : INT_MIN;
    }
  }
  // Columns past C sit after every real column: they never reach a
  // real column's prefix.
  for (int s = 0; s < steps; ++s) {
    v[0] = static_cast<int>(static_cast<unsigned>(v[0]) + s);
#pragma unroll
    for (int i = 1; i < N; ++i) {
      v[i] = max(static_cast<int>(static_cast<unsigned>(v[i]) + s),
                 v[i - 1]);
    }
    const int c = carry_in<SMEM>(v[N - 1], lane, sh[SMEM ? warp : 0]);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = max(v[i], c);
  }
  if constexpr (N % 4 == 0) {
    if (vec) {
      int4* o = reinterpret_cast<int4*>(out + r0 + c0);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        if (c0 + 4 * q < C) {
          at(o, q) = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                               v[4 * q + 3]);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (c0 + i < C) at(out, r0 + c0 + i) = v[i];
  }
}

template <int N>
void launch_n(const int* x, int B, int C, int steps, int lowering,
              bool vec, int* out, cudaStream_t s) {
  const int grid = (B + WARPS - 1) / WARPS;
  if (lowering == 0) {
    scan_kernel<N, false><<<grid, WARPS * 32, 0, s>>>(x, B, C, steps, vec,
                                                      out);
  } else {
    scan_kernel<N, true><<<grid, WARPS * 32, 0, s>>>(x, B, C, steps, vec,
                                                     out);
  }
}

// launch_n<n> for the n = 1 .. 32 columns a lane.
template <int... Ns>
void dispatch(int n, const int* x, int B, int C, int steps, int lowering,
              bool vec, int* out, cudaStream_t s,
              std::integer_sequence<int, Ns...>) {
  ((n == Ns + 1 ? launch_n<Ns + 1>(x, B, C, steps, lowering, vec, out, s)
                : void()),
   ...);
}

}  // namespace

// lowering: 0 shfl, 1 smem.  x, out: [B, C] int32, 1 <= C <= 1024.
extern "C" int dtt_scanshift(const int* x, int B, int C, int steps,
                             int lowering, int* out, void* stream) {
  if (B < 1 || C < 1 || C > 1024 || (lowering != 0 && lowering != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(s);
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  dispatch((C + 31) / 32, x, B, C, steps, lowering, vec, out, s,
           std::make_integer_sequence<int, 32>{});
  return static_cast<int>(cudaGetLastError());
}
