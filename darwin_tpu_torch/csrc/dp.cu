// GACT tile DP for Hopper (sm_90a), in four output formats and with one
// to four tiles a block.
//
// Replaces, in darwin_tpu/ops/pallas_dp.py::align_tiles_pallas: the
// interleave=1 pallas_call (line 523, kernel _make_kernel over
// _tile_math) in its three dir formats, and the interleave>1 stream
// pallas_call (line 493, _make_stream_kernel); and the plane-2 probe's
// kernel (tools/plane2_probe.py:209, kernel2), the packed6 DP plus a
// second word plane.  Contract: darwin_tpu/ops/reference_dp.py::
// align_tiles_jax, whose PyTorch port is darwin_tpu_torch/ops/
// reference_dp.py, followed for the word formats by the packers of
// darwin_tpu_torch/ops/pack.py.
//
// What it computes: for each of B tiles, the affine-gap local DP
// (match/mismatch/gap_open/gap_extend, int32 with a -(1<<30) sentinel)
// over a T x T tile; one direction byte per cell (op 0-3 with tie order
// m > i > d and 0 when h == 0, open-I flag 8, open-D flag 4, MATCH_BIT
// 16; 0 outside 1 <= j <= qlen, i <= rlen); the row-major-last max cell
// and the anchor-corner score.  The direction cells go out, [B, T, T+1],
// as
//   bytes   uint8 D[r, c];
//   packed  int32 D[r,c] | D[r,c+1]<<8 | D[r-1,c]<<16 | D[r-1,c+1]<<24;
//   packed6 int32 D[r,c] | D[r,c+1]<<5 | D[r-1,c]<<10 | D[r-1,c+1]<<15
//                 | D[r-2,c-1]<<20 | D[r-3,c-2]<<25;
//   plane2  the packed6 plane, and a second int32 plane
//                 D[r-4,c-2] | D[r-5,c-2]<<5 | D[r-6,c-3]<<10
// (cells outside the matrix read 0).  The TPU's 128-lane padding is not
// carried over.
//
// What bounds it on the H100: latency, not bytes.  At the main path's
// B = 512, T = 320 the batch is 52.6 M cells; the bytes it writes (52.6
// MB of dir bytes, or 210 MB of words) take 16-63 us of HBM time, and at
// about 40 instructions a cell they take 60-100 us to issue over 132 SMs.
// Each tile, though, is a chain of T dependent rows, and each row needs
// a block-wide prefix-max scan and two barriers; that chain sets the
// kernel's time.
//
// Design: one thread per DP column j = 0..T (blockDim = roundup(T+1,
// 32)), a loop over the rows, and IL tiles a block (IL = 1, 2, 4: the
// port of the TPU kernel's interleaved batch streams).  A thread keeps
// column j of each of its IL tiles in registers (m, i of the previous
// row); the IL rows' updates and their prefix-max scans are interleaved
// (scan.cuh), so one scan chain and one barrier pair per DP row serve IL
// tiles and the tiles' instructions fill each other's latency.  The
// query-gap term uses the closed form of align_tiles_jax,
// d[j] = (j-1)*ge + cummax_{l<=j-1}(m[l] + go - l*ge).  The max cell is
// tracked per column (last row at >=, as pallas_dp.py:228-233 defers it)
// and reduced once at the end over a (score, row, column) key.
//
// The word formats are written fused in the row loop.  Each thread
// shifts its column's 5-bit dir bytes into a history register (the rows
// above; pallas_dp.py:204-224 keeps tp/c1a..c1c for the same purpose)
// and publishes it in shared memory after the row's second barrier; a
// row's word is assembled after the NEXT row's first barrier from the
// thread's own history and its neighbours' (columns j+1, j-1, j-2, j-3),
// so the words need no barrier of their own.  Rows past rlen carry the
// bytes of the valid rows above them in their upper fields, so the loop
// runs to rlen + 1 (packed), rlen + 3 (packed6) or rlen + 6 (plane2) and
// zero-fills only the rows after that.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int NEG_INF = 1 << 30;
constexpr int GAP_OPEN_FLAG_I = 8;
constexpr int GAP_OPEN_FLAG_D = 4;
constexpr int MATCH_BIT = 16;

enum Format : int { kBytes = 0, kPacked = 1, kPacked6 = 2, kPlane2 = 3 };

// Hist: a column's dir bytes of the last rows, 5 bits each, newest in
// the low bits.  kExtraRows: how many rows past rlen a word still
// carries bytes of valid rows.
template <int FMT> struct Traits;
template <> struct Traits<kBytes> {
  using Hist = uint32_t;
  static constexpr int kExtraRows = 0;
};
template <> struct Traits<kPacked> {
  using Hist = uint32_t;
  static constexpr int kExtraRows = 1;
};
template <> struct Traits<kPacked6> {
  using Hist = uint32_t;
  static constexpr int kExtraRows = 3;
};
template <> struct Traits<kPlane2> {
  using Hist = unsigned long long;  // ages 0..6: 35 bits
  static constexpr int kExtraRows = 6;
};

// Two tiles or more a block hold IL times the state in registers: cap
// the block at 512 threads so the compiler may use 128 registers.
template <int IL> struct MaxThreads {
  static constexpr int value = IL == 1 ? 1024 : 512;
};

struct Args {
  const uint8_t* ref;
  const uint8_t* query;
  const int* ref_len;
  const int* query_len;
  int T, match, mismatch, go, ge;
  void* dir;   // uint8 bytes or int32 words [B, T, T+1]
  int* dir2;   // plane 2 (kPlane2 only)
  int* max_score;
  int* max_i;
  int* max_j;
  int* pos_score;
};

template <typename H>
__device__ __forceinline__ int field(H h, int age) {
  return static_cast<int>((h >> (5 * age)) & 31);
}

// Writes DP row `row` (1-based) of the IL tiles' words.  sh_hist holds
// every column's history up to that row, at offset 3 + column, with zero
// columns on both sides.
template <int IL, int FMT, typename Hist>
__device__ __forceinline__ void emit_words(const Args& a, int b0, int row,
                                           int j, const Hist (&hist)[IL],
                                           const Hist* sh_hist, int hw) {
  const int TJ = a.T + 1;
  if (j >= TJ) return;
  int* words = static_cast<int*>(a.dir);
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    const Hist* h = sh_hist + k * hw + 3 + j;
    const Hist own = hist[k];
    const Hist rt = h[1];
    const size_t at =
        (static_cast<size_t>(b0 + k) * a.T + (row - 1)) * TJ + j;
    if (FMT == kPacked) {
      words[at] = field(own, 0) | field(rt, 0) << 8 | field(own, 1) << 16 |
                  field(rt, 1) << 24;
    } else {
      const Hist l2 = h[-2];
      words[at] = field(own, 0) | field(rt, 0) << 5 | field(own, 1) << 10 |
                  field(rt, 1) << 15 | field(h[-1], 2) << 20 |
                  field(l2, 3) << 25;
      if (FMT == kPlane2) {
        a.dir2[at] = field(l2, 4) | field(l2, 5) << 5 | field(h[-3], 6) << 10;
      }
    }
  }
}

template <int IL, int FMT>
__global__ void __launch_bounds__(MaxThreads<IL>::value)
    align_tiles_kernel(const Args a) {
  using Hist = typename Traits<FMT>::Hist;
  constexpr bool kWords = FMT != kBytes;
  extern __shared__ long long smem_ll[];
  const int nthreads = blockDim.x;  // multiple of 32, > T
  const int nwarps = nthreads >> 5;
  const int hw = nthreads + 4;  // 3 zero columns left, 1 right
  long long* sh_key = smem_ll;                                  // [IL][32]
  Hist* sh_hist = reinterpret_cast<Hist*>(sh_key + IL * 32);    // [IL][hw]
  int* sh_m = reinterpret_cast<int*>(sh_hist + (kWords ? IL * hw : 0));
  int* sh_i = sh_m + IL * nthreads;                  // [IL][nthreads]
  int* sh_c = sh_i + IL * nthreads;                  // [IL][nthreads]
  int* sh_wmax = sh_c + IL * nthreads;               // [IL][32]
  uint8_t* sh_ref = reinterpret_cast<uint8_t*>(sh_wmax + IL * 32);  // [IL][T]

  const int T = a.T;
  const int TJ = T + 1;
  const int b0 = blockIdx.x * IL;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int lge = j * a.ge;

  int rlen[IL], qlen[IL], qc[IL];
  bool jvalid[IL];
  int rows_max = 0;
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    const size_t b = b0 + k;
    rlen[k] = a.ref_len[b];
    qlen[k] = a.query_len[b];
    jvalid[k] = j >= 1 && j <= qlen[k] && j <= T;
    const int rows =
        rlen[k] <= 0 ? 0 : min(rlen[k] + Traits<FMT>::kExtraRows, T);
    rows_max = max(rows_max, rows);
    for (int x = j; x < T; x += nthreads) sh_ref[k * T + x] = a.ref[b * T + x];
    // Column j holds query char j-1; column 0 (and the spare threads
    // past T) compare against 0, which no tile byte equals.
    qc[k] = (j >= 1 && j <= T) ? static_cast<int>(a.query[b * T + j - 1])
                               : 0;
  }
  if (kWords) {
    for (int x = j; x < IL * hw; x += nthreads) sh_hist[x] = 0;
  }
  __syncthreads();

  int m_prev[IL], i_prev[IL], left3[IL], best_h[IL], best_i[IL],
      corner_h[IL];
  Hist hist[IL];
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    m_prev[k] = 0;           // this column, previous row
    i_prev[k] = -NEG_INF;
    left3[k] = 0;  // max(m, i, d) of column j-1, previous row (row 0: 0)
    best_h[k] = -1;
    best_i[k] = 0;
    corner_h[k] = 0;
    hist[k] = 0;
  }

  for (int i = 1; i <= rows_max; ++i) {
    int m_new[IL], i_new[IL], u[IL], flags[IL];
#pragma unroll
    for (int k = 0; k < IL; ++k) {
      const bool is_eq = qc[k] == static_cast<int>(sh_ref[k * T + i - 1]);
      m_new[k] =
          j == 0 ? 0 : max(left3[k] + (is_eq ? a.match : a.mismatch), 0);
      const int ins_open = m_prev[k] + a.go;
      const int ins_ext = i_prev[k] + a.ge;
      i_new[k] = j == 0 ? -NEG_INF : max(ins_open, ins_ext);
      flags[k] = (ins_open >= ins_ext ? GAP_OPEN_FLAG_I : 0) +
                 (is_eq ? MATCH_BIT : 0);
      u[k] = m_new[k] + a.go - lge;
    }
    // Inclusive prefix max over columns of u[l] = m[l] + go - l*ge;
    // the first barrier of the row is inside.
    dtt::block_inclusive_max<IL>(u, lane, warp, sh_wmax);
    if constexpr (kWords) {
      if (i > 1) emit_words<IL, FMT>(a, b0, i - 1, j, hist, sh_hist, hw);
    }
#pragma unroll
    for (int k = 0; k < IL; ++k) {
      sh_m[k * nthreads + j] = m_new[k];
      sh_i[k * nthreads + j] = i_new[k];
      sh_c[k * nthreads + j] = u[k];
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < IL; ++k) {
      const int* cm = sh_m + k * nthreads;
      const int* cc = sh_c + k * nthreads;
      int d_new, del_open, del_ext;
      if (j == 0) {
        d_new = -NEG_INF;
        del_open = a.go;
        del_ext = -NEG_INF + a.ge;
        left3[k] = 0;
      } else {
        d_new = cc[j - 1] + lge - a.ge;
        const int m_l = cm[j - 1];
        const int d_l = j == 1 ? -NEG_INF : cc[j - 2] + lge - 2 * a.ge;
        del_open = m_l + a.go;
        del_ext = d_l + a.ge;
        left3[k] = max(max(m_l, sh_i[k * nthreads + j - 1]), d_l);
      }
      const int h = max(max(m_new[k], i_new[k]), max(d_new, 0));

      int op;
      if (m_new[k] >= i_new[k]) {
        op = m_new[k] >= d_new ? 3 : 1;
      } else {
        op = i_new[k] >= d_new ? 2 : 1;
      }
      if (m_new[k] <= 0 && i_new[k] <= 0 && d_new <= 0) op = 0;
      op += flags[k] + (del_open >= del_ext ? GAP_OPEN_FLAG_D : 0);
      const bool valid = jvalid[k] && i <= rlen[k];
      const int opb = valid ? op : 0;
      if constexpr (kWords) {
        hist[k] = (hist[k] << 5) | static_cast<Hist>(opb);
        sh_hist[k * hw + 3 + j] = hist[k];
      } else if (j < TJ) {
        static_cast<uint8_t*>(a.dir)[(static_cast<size_t>(b0 + k) * T +
                                      (i - 1)) * TJ + j] =
            static_cast<uint8_t>(opb);
      }
      if (valid && h >= best_h[k]) {
        best_h[k] = h;
        best_i[k] = i;
      }
      if (i == rlen[k] && j == qlen[k]) corner_h[k] = h;
      m_prev[k] = m_new[k];
      i_prev[k] = i_new[k];
    }
  }
  if constexpr (kWords) {
    if (rows_max > 0) {
      __syncthreads();
      emit_words<IL, FMT>(a, b0, rows_max, j, hist, sh_hist, hw);
    }
  }

  // The rows after rows_max hold no byte of a valid row: all zero.
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    const size_t base = static_cast<size_t>(b0 + k) * T * TJ;
    const size_t end = static_cast<size_t>(T) * TJ;
    for (size_t x = static_cast<size_t>(rows_max) * TJ + j; x < end;
         x += nthreads) {
      if (kWords) {
        static_cast<int*>(a.dir)[base + x] = 0;
        if (FMT == kPlane2) a.dir2[base + x] = 0;
      } else {
        static_cast<uint8_t*>(a.dir)[base + x] = 0;
      }
    }
  }

  // Row-major-last max cell: the largest (score, row, column) key over
  // the valid columns; none (rlen <= 0 or qlen <= 0) reports (0, 0, 0).
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    long long key = (jvalid[k] && best_h[k] >= 0)
                        ? (static_cast<long long>(best_h[k]) << 32) |
                              (static_cast<long long>(best_i[k]) << 16) | j
                        : -1LL;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      key = max(key, __shfl_down_sync(dtt::kFullMask, key, s));
    }
    if (lane == 0) sh_key[k * 32 + warp] = key;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    const int b = b0 + k;
    if (j == k) {
      long long key = -1;
      for (int w = 0; w < nwarps; ++w) key = max(key, sh_key[k * 32 + w]);
      const bool found = key >= 0;
      a.max_score[b] = found ? static_cast<int>(key >> 32) : 0;
      a.max_i[b] = found ? static_cast<int>((key >> 16) & 0xffff) : 0;
      a.max_j[b] = found ? static_cast<int>(key & 0xffff) : 0;
      if (qlen[k] < 0 || qlen[k] > T) a.pos_score[b] = 0;
    }
    if (j == qlen[k] && j <= T) a.pos_score[b] = corner_h[k];
  }
}

template <int IL, int FMT>
int launch(const Args& a, int B, cudaStream_t stream) {
  using Hist = typename Traits<FMT>::Hist;
  const int threads = (a.T + 1 + 31) / 32 * 32;
  if (threads > MaxThreads<IL>::value || B % IL != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      IL * (32 * sizeof(long long) +
            (FMT != kBytes ? (threads + 4) * sizeof(Hist) : 0) +
            (3 * static_cast<size_t>(threads) + 32) * sizeof(int) +
            static_cast<size_t>(a.T));
  align_tiles_kernel<IL, FMT><<<B / IL, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fmt: 0 bytes (dir uint8), 1 packed, 2 packed6 (dir int32), 3 plane2
// (dir and dir2 int32; interleave 1 only).  interleave: 1, 2 or 4 tiles
// a block; B % interleave == 0.
extern "C" int dtt_align_tiles(const uint8_t* ref, const uint8_t* query,
                               const int* ref_len, const int* query_len,
                               int B, int T, int match, int mismatch,
                               int gap_open, int gap_extend, int fmt,
                               int interleave, void* dir, int* dir2,
                               int* max_score, int* max_i, int* max_j,
                               int* pos_score, void* stream) {
  const Args a{ref,      query,    ref_len,  query_len, T,
               match,    mismatch, gap_open, gap_extend, dir,
               dir2,     max_score, max_i,   max_j,     pos_score};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt * 8 + interleave) {
    case kBytes * 8 + 1: return launch<1, kBytes>(a, B, s);
    case kBytes * 8 + 2: return launch<2, kBytes>(a, B, s);
    case kBytes * 8 + 4: return launch<4, kBytes>(a, B, s);
    case kPacked * 8 + 1: return launch<1, kPacked>(a, B, s);
    case kPacked * 8 + 2: return launch<2, kPacked>(a, B, s);
    case kPacked * 8 + 4: return launch<4, kPacked>(a, B, s);
    case kPacked6 * 8 + 1: return launch<1, kPacked6>(a, B, s);
    case kPacked6 * 8 + 2: return launch<2, kPacked6>(a, B, s);
    case kPacked6 * 8 + 4: return launch<4, kPacked6>(a, B, s);
    case kPlane2 * 8 + 1: return launch<1, kPlane2>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
