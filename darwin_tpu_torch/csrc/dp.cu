// GACT tile DP for Hopper (sm_90a).
//
// Replaces: darwin_tpu/ops/pallas_dp.py, align_tiles_pallas (the
// pallas_call at line 523; kernel body _make_kernel over _tile_math).
// Contract: darwin_tpu/ops/reference_dp.py::align_tiles_jax, whose
// PyTorch port is darwin_tpu_torch/ops/reference_dp.py.
//
// What it computes: for each of B tiles, the affine-gap local DP
// (match/mismatch/gap_open/gap_extend, int32 with a -(1<<30) sentinel)
// over a T x T tile; one direction byte per cell (op 0-3 with tie order
// m > i > d and 0 when h == 0, open-I flag 8, open-D flag 4, MATCH_BIT
// 16; 0 outside 1 <= j <= qlen, i <= rlen) into dir[B, T, T+1]; the
// row-major-last max cell and the anchor-corner score.
//
// What bounds it on the H100: latency, not bytes.  At the main path's
// B = 512, T = 320 the tile batch is 52.6 M cells and 52.6 MB of dir
// bytes written once, about 16 us of HBM time.  At about 40
// instructions a cell it is some 2 G thread-instructions, 60-100 us of
// issue across 132 SMs.  Each tile, though, is a chain of T dependent
// rows, and each row needs a block-wide prefix-max scan and two
// barriers; that chain, not the issue rate, sets the kernel's time.
//
// Design: one thread block per tile, one thread per DP column
// j = 0..T (blockDim = roundup(T+1, 32) <= 1024), a loop over the
// rows.  A thread keeps its own column's m/i of the previous row in
// registers; the left neighbour's values arrive through shared memory.
// The query-gap term uses the closed form of align_tiles_jax,
// d[j] = (j-1)*ge + cummax_{l<=j-1}(m[l] + go - l*ge), as a warp
// shuffle scan plus a per-warp carry.  Dir-byte stores are coalesced
// across the block.  The max cell is tracked per column (last row at
// >=, as pallas_dp.py:228-233 defers it) and reduced once at the end
// over a (score, row, column) key.  Rows past rlen are not computed:
// their dir bytes are zero-filled.  Several blocks share an SM
// (352 threads at T = 320), so one block's barrier waits are covered by
// the others; the whole batch of 512 tiles is resident at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = 1 << 30;
constexpr int GAP_OPEN_FLAG_I = 8;
constexpr int GAP_OPEN_FLAG_D = 4;
constexpr int MATCH_BIT = 16;

__device__ __forceinline__ int warp_inclusive_max(int v, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, s);
    if (lane >= s) v = max(v, o);
  }
  return v;
}

__global__ void align_tiles_kernel(
    const uint8_t* __restrict__ ref, const uint8_t* __restrict__ query,
    const int* __restrict__ ref_len, const int* __restrict__ query_len,
    int T, int match, int mismatch, int go, int ge,
    uint8_t* __restrict__ dir, int* __restrict__ max_score,
    int* __restrict__ max_i, int* __restrict__ max_j,
    int* __restrict__ pos_score) {
  extern __shared__ long long smem_ll[];
  const int nthreads = blockDim.x;  // multiple of 32, > T
  const int nwarps = nthreads >> 5;
  long long* sh_key = smem_ll;                       // [32]
  int* sh_m = reinterpret_cast<int*>(sh_key + 32);   // [nthreads]
  int* sh_i = sh_m + nthreads;                       // [nthreads]
  int* sh_c = sh_i + nthreads;                       // [nthreads]
  int* sh_wmax = sh_c + nthreads;                    // [32]
  uint8_t* sh_ref = reinterpret_cast<uint8_t*>(sh_wmax + 32);  // [T]

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int TJ = T + 1;
  const int rlen = ref_len[b];
  const int qlen = query_len[b];
  const int rows = min(max(rlen, 0), T);
  const bool jvalid = j >= 1 && j <= qlen && j <= T;

  const uint8_t* ref_b = ref + static_cast<size_t>(b) * T;
  for (int k = j; k < T; k += nthreads) sh_ref[k] = ref_b[k];
  // Column j holds query char j-1; column 0 (and the spare threads
  // past T) compare against 0, which no tile byte equals.
  const uint8_t* query_b = query + static_cast<size_t>(b) * T;
  const int qc = (j >= 1 && j <= T) ? static_cast<int>(query_b[j - 1]) : 0;
  __syncthreads();

  int m_prev = 0, i_prev = -NEG_INF;  // this column, previous row
  int left3 = 0;  // max(m, i, d) of column j-1, previous row (row 0: 0)
  int best_h = -1, best_i = 0, corner_h = 0;
  const int lge = j * ge;
  uint8_t* dir_b = dir + static_cast<size_t>(b) * T * TJ;

  for (int i = 1; i <= rows; ++i) {
    const bool is_eq = qc == static_cast<int>(sh_ref[i - 1]);
    const int m_new = j == 0 ? 0 : max(left3 + (is_eq ? match : mismatch), 0);
    const int ins_open = m_prev + go;
    const int ins_ext = i_prev + ge;
    const int i_new = j == 0 ? -NEG_INF : max(ins_open, ins_ext);

    // Inclusive prefix max over columns of u[l] = m[l] + go - l*ge.
    int c = warp_inclusive_max(m_new + go - lge, lane);
    if (lane == 31) sh_wmax[warp] = c;
    __syncthreads();
    for (int w = 0; w < warp; ++w) c = max(c, sh_wmax[w]);
    sh_m[j] = m_new;
    sh_i[j] = i_new;
    sh_c[j] = c;
    __syncthreads();

    int d_new, del_open, del_ext;
    if (j == 0) {
      d_new = -NEG_INF;
      del_open = go;
      del_ext = -NEG_INF + ge;
      left3 = 0;
    } else {
      d_new = sh_c[j - 1] + lge - ge;
      const int m_l = sh_m[j - 1];
      const int d_l = j == 1 ? -NEG_INF : sh_c[j - 2] + lge - 2 * ge;
      del_open = m_l + go;
      del_ext = d_l + ge;
      left3 = max(max(m_l, sh_i[j - 1]), d_l);
    }
    const int h = max(max(m_new, i_new), max(d_new, 0));

    int op;
    if (m_new >= i_new) {
      op = m_new >= d_new ? 3 : 1;
    } else {
      op = i_new >= d_new ? 2 : 1;
    }
    if (m_new <= 0 && i_new <= 0 && d_new <= 0) op = 0;
    if (ins_open >= ins_ext) op += GAP_OPEN_FLAG_I;
    if (del_open >= del_ext) op += GAP_OPEN_FLAG_D;
    if (is_eq) op += MATCH_BIT;
    if (j < TJ) {
      dir_b[static_cast<size_t>(i - 1) * TJ + j] =
          jvalid ? static_cast<uint8_t>(op) : 0;
    }

    if (jvalid && h >= best_h) {
      best_h = h;
      best_i = i;
    }
    if (i == rlen && j == qlen) corner_h = h;
    m_prev = m_new;
    i_prev = i_new;
  }

  // Rows past rlen are all ZERO.
  for (size_t k = static_cast<size_t>(rows) * TJ + j;
       k < static_cast<size_t>(T) * TJ; k += nthreads) {
    dir_b[k] = 0;
  }

  // Row-major-last max cell: the largest (score, row, column) key over
  // the valid columns; none (rlen <= 0 or qlen <= 0) reports (0, 0, 0).
  long long key = (jvalid && best_h >= 0)
                      ? (static_cast<long long>(best_h) << 32) |
                            (static_cast<long long>(best_i) << 16) | j
                      : -1LL;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    key = max(key, __shfl_down_sync(0xffffffffu, key, s));
  }
  if (lane == 0) sh_key[warp] = key;
  __syncthreads();
  if (j == 0) {
    long long k = -1;
    for (int w = 0; w < nwarps; ++w) k = max(k, sh_key[w]);
    const bool found = k >= 0;
    max_score[b] = found ? static_cast<int>(k >> 32) : 0;
    max_i[b] = found ? static_cast<int>((k >> 16) & 0xffff) : 0;
    max_j[b] = found ? static_cast<int>(k & 0xffff) : 0;
    if (qlen < 0 || qlen > T) pos_score[b] = 0;
  }
  if (j == qlen && j <= T) pos_score[b] = corner_h;
}

}  // namespace

extern "C" int dtt_align_tiles(const uint8_t* ref, const uint8_t* query,
                               const int* ref_len, const int* query_len,
                               int B, int T, int match, int mismatch,
                               int gap_open, int gap_extend, uint8_t* dir,
                               int* max_score, int* max_i, int* max_j,
                               int* pos_score, void* stream) {
  const int threads = (T + 1 + 31) / 32 * 32;
  const size_t smem = 32 * sizeof(long long) +
                      (3 * static_cast<size_t>(threads) + 32) * sizeof(int) +
                      static_cast<size_t>(T);
  align_tiles_kernel<<<B, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      ref, query, ref_len, query_len, T, match, mismatch, gap_open,
      gap_extend, dir, max_score, max_i, max_j, pos_score);
  return static_cast<int>(cudaGetLastError());
}
