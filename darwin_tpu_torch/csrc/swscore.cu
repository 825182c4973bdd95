// Score-only local Smith-Waterman with affine gaps, any length, for
// Hopper (sm_90a).
//
// Replaces: darwin_tpu/ops/swscore.py, local_score_batch (line 33), the
// exact scorer of the NPBSS score evaluator (darwin_tpu/eval/
// score_eval.py).  That function is plain XLA, not Pallas; it is a
// kernel here because in eager PyTorch each DP row is a dozen launches
// (ops/swscore.py::local_score_batch_torch is its lockstep port).
//
// What it computes: for each pair b, the maximum over rows 1..rlen and
// columns 1..qlen of H = max(M, I, D), where (NEG_INF = 1 << 30)
//   M[i][j] = max(H[i-1][j-1] + s(ref[i-1], query[j-1]), 0), M[i][0] = 0
//   I[i][j] = max(M[i-1][j] + gap_open, I[i-1][j] + gap_extend)
//   D[i][j] = max(M[i][j-1] + gap_open, D[i][j-1] + gap_extend)
// with I and D -NEG_INF in column 0 and row 0, M and H 0 in row 0.  The
// JAX computes D as a prefix max along the row,
// D[j] = max_{k<j} (M[k] + gap_open + (j-1-k) * gap_extend), which is
// the same integer as the recurrence above.  Cells past rlen or qlen
// never feed a valid cell (they lie below or to the right), so the
// kernel does not compute the rows past rlen and leaves the columns past
// qlen out of the maximum; the JAX masks them instead.
//
// What bounds it on the H100: integer issue, once the DP's dependency
// chain is spread over enough warps.  A cell is eight integer
// instructions (the score: a compare and a select; M, I and D: one
// __viaddmax_s32 each; H: __vimax3_s32; the column's running maximum;
// M + gap_open), a step of a lane about seventy more (shuffles, the
// ring, the ref byte, bounds, the loop).  Memory traffic is the two
// sequences once and, for queries longer than one pass, a boundary
// column a pass.
//
// Design: one block of W = kWarps (8) warps a pair.  Lane l of warp w
// owns C
// contiguous columns of its strip in registers (C from the query width,
// so that W * 32 * C columns, one pass, cover it where C <= 16), with
// their M + gap_open, I and H of the row above, their query characters
// and their maximum H so far (folded into the pair's maximum, past-qlen
// columns left out, when the strip ends); the lanes of a warp run an
// anti-diagonal wavefront (row s
// - l at the warp's step s), taking the left boundary (M + gap_open and
// D of the same row, H of the row above) from lane l - 1 by
// __shfl_up_sync, as csrc/dp.cu does.  The warps are pipelined across
// the strips: warp w runs L = 31 + K steps behind warp w - 1, and its
// lane 0 takes the left boundary from a ring of RING rows in shared
// memory that warp w - 1's lane 31 fills; the block meets at a barrier
// every K steps, which orders each ring write before its read and each
// read before the slot is written again.  A query wider than one pass
// goes round again: strip W of pass p + 1 follows strip W - 1 of pass p,
// through a boundary column in global scratch ([B, LR + 1] int4), the
// only global traffic besides the sequences; a pass lasts P = max(rlen +
// 31, (W - 1) L + 31 + K) steps, so that scratch row i is written a
// barrier before it is read.  The ref is staged in shared memory once
// (up to kRefCap bytes; a longer ref takes the BIG instantiation, whose
// rows past that read global memory).  4 and 16 warps a block, and a
// cluster of two blocks of 4 warps a pair at B = 64, measured slower than
// one block of 8 (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "checked.cuh"

namespace {

using dtt::at;

constexpr int NEG_INF = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;
constexpr int kWarps = 8;     // warps a block, one block a pair
constexpr int K = 8;           // steps between block barriers
constexpr int L = 31 + K;      // steps warp w runs behind warp w - 1
constexpr int RING = 64;       // boundary rows a ring holds (>= 2 K)
constexpr int kRefCap = 160 * 1024;  // ref bytes staged in shared memory

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Shared memory by 32-bit shared-window addresses, taken once: through a
// generic pointer the compiler forms the window address anew every step.
__device__ __forceinline__ int lds_u8(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return static_cast<int>(v);
}
__device__ __forceinline__ int4 lds_v4(unsigned a) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts_v4(unsigned a, int4 v) {
  asm volatile("st.shared.v4.s32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// BIG: the ref is longer than kRefCap, and its rows past that are read
// from global memory.
template <int C, bool BIG>
__global__ void __launch_bounds__(kWarps * 32)
    sw_kernel(const uint8_t* __restrict__ ref,
              const uint8_t* __restrict__ query,
              const int* __restrict__ ref_len,
              const int* __restrict__ query_len, int LR, int LQ, int match,
              int mismatch, int go, int ge, int4* __restrict__ scratch,
              int* __restrict__ best_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int W = kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int rows = min(max(at(ref_len, b), 0), LR);
  const int cols = min(max(at(query_len, b), 0), LQ);
  if (rows == 0 || cols == 0) {  // the whole block
    if (threadIdx.x == 0) at(best_out, b) = 0;
    return;
  }
  // Ring w (w >= 1) carries warp w - 1's right boundary to warp w:
  // (M + go, D, H of the row above) by running step.
  int4* rings = reinterpret_cast<int4*>(smem);
  int* red = reinterpret_cast<int*>(rings + W * RING);
  uint8_t* sref = reinterpret_cast<uint8_t*>(red + W);
  // This warp's ring (read by lane 0) and the next warp's (written by
  // lane 31), and the staged ref, as shared-window addresses.
  const unsigned ring_in =
      static_cast<unsigned>(__cvta_generic_to_shared(rings + warp * RING));
  const unsigned ring_out = ring_in + RING * sizeof(int4);
  const unsigned sref_s =
      static_cast<unsigned>(__cvta_generic_to_shared(sref)) - 1;
  const uint8_t* r = ref + static_cast<int64_t>(b) * LR;
  const uint8_t* q = query + static_cast<int64_t>(b) * LQ;
  // The boundary column between passes: (M + go, D, H of the row above)
  // by row.
  int4* bnd = scratch + static_cast<int64_t>(b) * (LR + 1);
  for (int x = threadIdx.x; x < min(rows, kRefCap); x += blockDim.x) {
    sref[x] = at(r, x);
  }
  __syncthreads();

  const int span = W * 32 * C;  // columns a pass
  const int npass = (cols + span - 1) / span;
  const int P = max(rows + 31, (W - 1) * L + 31 + K);
  const int total = (npass - 1) * P + (W - 1) * L + rows + 31;

  int qc[C];       // the strip's query characters, -1 past qlen
  int colbest[C];  // each column's maximum H over the strip's rows
  int mgo_up[C], i_up[C], h_up[C];
  int nvalid = 0;  // columns of the lane's strip up to qlen
  int out_mgo = 0, out_d = 0, out_hd = 0;
  int best = 0;
  // The finished strip's columns up to qlen into best.
  auto fold = [&]() {
#pragma unroll
    for (int c = 0; c < C; ++c) best = max(best, c < nvalid ? colbest[c] : 0);
  };
  int t = -warp * L;  // this warp's running step
  int p = 0, s = 0;   // its pass, and its step in the pass (1..P)
  bool active = false;
  for (int g = 1; g <= total; ++g) {
    if (++t >= 1) {
      if (++s > P) {
        s = 1;
        ++p;
      }
      if (s == 1) {  // a new strip: its query characters, row 0
        fold();
        const int j0 = (p * W + warp) * 32 * C;  // columns before it
        active = p < npass && j0 < cols;
        const int jl = j0 + lane * C;
        nvalid = active ? min(max(cols - jl, 0), C) : 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          qc[c] = c < nvalid ? at(q, jl + c) : -1;
          colbest[c] = 0;
          mgo_up[c] = go;
          i_up[c] = -NEG_INF;
          h_up[c] = 0;
        }
      }
      if (active && s <= rows + 31) {
        const int i = s - lane;  // this lane's row
        int mgo = __shfl_up_sync(FULL, out_mgo, 1);
        int d = __shfl_up_sync(FULL, out_d, 1);
        int diag = __shfl_up_sync(FULL, out_hd, 1);
        if (i >= 1 && i <= rows) {
          if (lane == 0) {
            int4 v;
            if (warp > 0) {
              v = lds_v4(ring_in + (t & (RING - 1)) * sizeof(int4));
            } else if (p > 0) {
              v = at(bnd, i);
            } else {  // column 0
              v = make_int4(go, -NEG_INF, 0, 0);
            }
            mgo = v.x;
            d = v.y;
            diag = v.z;
          }
          const int rc =
              BIG && i > kRefCap ? at(r, i - 1) : lds_u8(sref_s + i);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int m = __viaddmax_s32(
                diag, qc[c] == rc ? match : mismatch, 0);
            diag = h_up[c];
            const int ii = __viaddmax_s32(i_up[c], ge, mgo_up[c]);
            d = __viaddmax_s32(d, ge, mgo);
            const int h = __vimax3_s32(m, ii, d);
            colbest[c] = max(colbest[c], h);
            mgo = m + go;
            mgo_up[c] = mgo;
            i_up[c] = ii;
            h_up[c] = h;
          }
          out_mgo = mgo;
          out_d = d;
          out_hd = diag;
          const int4 v = make_int4(mgo, d, diag, 0);
          if (lane == 31 && warp + 1 < W) {
            sts_v4(ring_out + ((t - 31) & (RING - 1)) * sizeof(int4), v);
          }
          if (lane == 31 && warp + 1 == W && p + 1 < npass) at(bnd, i) = v;
        }
      }
    }
    if ((g & (K - 1)) == 0) __syncthreads();
  }
  fold();
  for (int o = 16; o > 0; o >>= 1) {
    best = max(best, __shfl_xor_sync(FULL, best, o));
  }
  if (lane == 0) red[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < W; ++w) best = max(best, red[w]);
    at(best_out, b) = best;
  }
}

template <int C, bool BIG>
int launch(const uint8_t* ref, const uint8_t* query, const int* ref_len,
           const int* query_len, int B, int LR, int LQ, int match,
           int mismatch, int go, int ge, int4* scratch, int* best,
           cudaStream_t stream) {
  const int smem = kWarps * RING * static_cast<int>(sizeof(int4)) +
                   kWarps * static_cast<int>(sizeof(int)) +
                   round16(min(LR, kRefCap));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_kernel<C, BIG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sw_kernel<C, BIG><<<B, 32 * kWarps, smem, stream>>>(
      ref, query, ref_len, query_len, LR, LQ, match, mismatch, go, ge,
      scratch, best);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: B * (LR + 1) * 4 ints, 16-byte aligned, used only by queries
// wider than one pass (kWarps * 32 * 16 columns).
extern "C" int dtt_local_score(const uint8_t* ref, const uint8_t* query,
                               const int* ref_len, const int* query_len,
                               int B, int LR, int LQ, int match,
                               int mismatch, int gap_open, int gap_extend,
                               int* scratch, int* best, void* stream) {
  if (B <= 0 || LR < 0 || LQ < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  // The least C of 2, 4, 6, 8, 12, 16 with one pass over LQ columns.
  const int c = (LQ + 32 * kWarps - 1) / (32 * kWarps);
  const auto run = [&](auto kernel_c) {
    constexpr int C = decltype(kernel_c)::value;
    const auto go = LR > kRefCap ? launch<C, true> : launch<C, false>;
    return go(ref, query, ref_len, query_len, B, LR, LQ, match, mismatch,
              gap_open, gap_extend, reinterpret_cast<int4*>(scratch), best,
              st);
  };
  if (c <= 2) return run(std::integral_constant<int, 2>{});
  if (c <= 4) return run(std::integral_constant<int, 4>{});
  if (c <= 6) return run(std::integral_constant<int, 6>{});
  if (c <= 8) return run(std::integral_constant<int, 8>{});
  if (c <= 12) return run(std::integral_constant<int, 12>{});
  return run(std::integral_constant<int, 16>{});
}
