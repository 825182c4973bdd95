// GACT tile DP for Hopper (sm_90a), in four output formats and with one,
// two or four tiles a warp.
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
// What bounds it on the H100: integer issue.  At the main path's B =
// 512, T = 320 the batch is 52.4 M cells; at about 15 integer
// instructions a cell (two of them DPX) over 132 SMs x 64 INT32 lanes x
// 1.98 GHz = 16.7 T instructions/s that is 47 us, while the 52.6 MB of
// dir bytes take 16 us of HBM time (the word formats' 210 MB, 63 us;
// plane 2 at B = 2048, T = 376: 2.3 GB, 0.69 ms).  The TPU kernel's
// closed-form query-gap term, d[j] = (j-1)*ge + cummax(m[l] + go - l*ge),
// needs a row-wide prefix scan; on this card that scan, with a block
// barrier or two a row, made each tile a chain of T latency-bound rows.
//
// Design: one warp a tile.  Lane l owns the C = ceil(T/32) contiguous
// columns l*C+1 .. l*C+C (a compile-time strip width, C in 2..32), and
// holds their M + go, I + ge and H of the row above and their query
// characters in registers.  The lanes run an anti-diagonal wavefront: at
// step s lane l computes row s - l across its strip, taking its left
// boundary (M + go and D + ge of the same row, H of the row above, at its
// left neighbour's last column) from lane l-1 by three __shfl_up_sync a
// step.  The query-gap term is the recurrence D[j] = max(M[j-1] + go,
// D[j-1] + ge) with its open flag del_open >= del_ext, which gives the
// closed form's integers and flags (csrc/swscore.cu does the same).
// The recurrences use the DPX instructions of sm_90: __viaddmax_s32 for
// M = max(H_diag + s, 0), __vibmax_s32 for I and D with their open
// flags (a max with its >= predicate), __vimax3_s32 for H = max(m, i, d)
// (the op's tie order m > i > d is then m == h, i == h) and to fold the
// max-cell keys.  There is no block barrier, no prefix scan and no
// shared-memory round trip in the recurrence.
//
// Direction bytes go through a ring of R = 33 + lag rows x (32C + 8)
// bytes a tile in shared memory: each lane stores its strip's bytes of
// its row, and after lane 31 finishes row r (step r + 31) the warp writes
// row r out, coalesced: the bytes as they are, a word format assembled
// from the ring's rows r-lag .. r (lag 0, 1, 3, 6 for bytes, packed,
// packed6, plane2), all of which the ring still holds.  The lanes store
// every byte they compute; the writer masks the columns past qlen (the
// word formats zero them in the ring once, before row r is written) and
// reads the rows past rlen as a zero row, so the words of rows rlen+1 ..
// rlen+lag come out as the packers make them, and the rows after that are
// zero-filled.  A lane waits for its first row (step lane + 1) and runs
// on past the tile's last row, so the steady steps have no per-lane
// branch around the recurrence.
//
// The max cell: each lane tracks the row-major-last maximum over its own
// strip (a row's best key h*64 + column, columns past qlen pushed below
// zero, then >= against the rows before it), and the warp reduces the
// lanes' (score, row, column) keys at the end.  Interleave IL: the IL
// tiles of a warp step together, their instructions interleaved (the
// Hopper form of the TPU kernel's IL independent streams); the results
// are the same for every IL.  A block holds `warps` warps (launch
// parameter, measured by the lab's geometry sweep).

#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

using dtt::at;

constexpr int NEG_INF = 1 << 30;
constexpr int GAP_OPEN_FLAG_I = 8;
constexpr int GAP_OPEN_FLAG_D = 4;
constexpr int MATCH_BIT = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 227 * 1024;
// Zero bytes left of column 0 in a ring row: the word formats read
// columns down to c - 3, and column 0 then starts 4-aligned.
constexpr int kPadL = 4;

enum Format : int { kBytes = 0, kPacked = 1, kPacked6 = 2, kPlane2 = 3 };

// Rows of the ring above the row a word is emitted for.
template <int FMT> struct Lag {
  static constexpr int value =
      FMT == kBytes ? 0 : FMT == kPacked ? 1 : FMT == kPacked6 ? 3 : 6;
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Ring geometry: rows in flight (32, one a lane) plus the lag plus the
// row being emitted, of 32C + 8 bytes (kPadL, column 0, 32C strip
// columns, and zero columns on the right), and after them one row that
// stays zero; 16-byte aligned.
template <int C, int FMT> struct Ring {
  static constexpr int kRows = 33 + Lag<FMT>::value;
  static constexpr int kRowBytes = 32 * C + 8;
  static constexpr int kBytes = round16((kRows + 1) * kRowBytes);
};

struct Args {
  const uint8_t* ref;
  const uint8_t* query;
  const int* ref_len;
  const int* query_len;
  int B, T, match, mismatch, go, ge;
  void* dir;   // uint8 bytes or int32 words [B, T, T+1]
  int* dir2;   // plane 2 (kPlane2 only)
  int* max_score;
  int* max_i;
  int* max_j;
  int* pos_score;
};

// Row x of a ring at its column 0: DP row x for 1 <= x <= rl, else
// the zero row (row 0 and the rows past rlen hold no direction byte).
template <int C, int FMT>
__device__ __forceinline__ const uint8_t* ring_row(const uint8_t* ring,
                                                   int x, int rl) {
  using R = Ring<C, FMT>;
  const int slot = x >= 1 && x <= rl ? (x - 1) % R::kRows : R::kRows;
  return ring + slot * R::kRowBytes + kPadL;
}

// The warp copies columns 0 .. n-1 of a ring row src (4-aligned,
// readable 4 bytes past n) to global dst (any alignment), the columns
// past qv as 0: bytes up to dst's next 4-byte boundary, then aligned
// words funnel-shifted out of src's words, then the tail.
__device__ __forceinline__ void copy_row(uint8_t* dst, const uint8_t* src,
                                         int n, int qv, int lane) {
  const int h = min((4 - static_cast<int>(
                              reinterpret_cast<uintptr_t>(dst) & 3)) & 3, n);
  if (lane < h) at(dst, lane) = lane <= qv ? src[lane] : 0;
  const int nw = (n - h) >> 2;
  uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + h);
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
  for (int x = lane; x < nw; x += 32) {
    uint32_t w = __funnelshift_r(s32[x], s32[x + 1], 8 * h);
    const int nv = qv - (h + 4 * x) + 1;  // the word's bytes up to qv
    if (nv < 4) w = nv <= 0 ? 0 : w & ((1u << (8 * nv)) - 1);
    at(d32, x) = w;
  }
  for (int x = h + 4 * nw + lane; x < n; x += 32) {
    at(dst, x) = x <= qv ? src[x] : 0;
  }
}

// The warp zero-fills n bytes at global p.
__device__ __forceinline__ void zero_bytes(uint8_t* p, size_t n, int lane) {
  const size_t h = min(static_cast<size_t>(
                           (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15),
                       n);
  if (static_cast<size_t>(lane) < h) at(p, lane) = 0;
  const size_t n16 = (n - h) >> 4;
  uint4* q = reinterpret_cast<uint4*>(p + h);
  for (size_t x = lane; x < n16; x += 32) at(q, x) = make_uint4(0, 0, 0, 0);
  for (size_t x = h + 16 * n16 + lane; x < n; x += 32) at(p, x) = 0;
}

// The warp writes DP row r (1-based) of tile b from its ring: bytes
// with their columns past qv = min(qlen, T) as 0; words from ring rows
// that hold zeros past qv already.  Rows past rl read as the zero row.
template <int C, int FMT>
__device__ __forceinline__ void emit_row(const Args& a, int b, int r,
                                         const uint8_t* ring, int rl,
                                         int qv, int lane) {
  const int TJ = a.T + 1;
  const size_t off = (static_cast<size_t>(b) * a.T + (r - 1)) * TJ;
  const uint8_t* r0 = ring_row<C, FMT>(ring, r, rl);
  if constexpr (FMT == kBytes) {
    copy_row(static_cast<uint8_t*>(a.dir) + off, r0, TJ, qv, lane);
  } else {
    const uint8_t* r1 = ring_row<C, FMT>(ring, r - 1, rl);
    int* words = static_cast<int*>(a.dir) + off;
    // Every field's column lies in c - 3 .. c + 1 (kPadL zero columns
    // on the left, zero columns past qlen on the right).
    for (int c = lane; c < TJ; c += 32) {
      if constexpr (FMT == kPacked) {
        at(words, c) = r0[c] | r0[c + 1] << 8 | r1[c] << 16 | r1[c + 1] << 24;
      } else {
        const uint8_t* r2 = ring_row<C, FMT>(ring, r - 2, rl);
        const uint8_t* r3 = ring_row<C, FMT>(ring, r - 3, rl);
        at(words, c) = r0[c] | r0[c + 1] << 5 | r1[c] << 10 |
                       r1[c + 1] << 15 | r2[c - 1] << 20 | r3[c - 2] << 25;
        if constexpr (FMT == kPlane2) {
          at(a.dir2, off + c) = ring_row<C, FMT>(ring, r - 4, rl)[c - 2] |
                                ring_row<C, FMT>(ring, r - 5, rl)[c - 2] << 5 |
                                ring_row<C, FMT>(ring, r - 6, rl)[c - 3] << 10;
        }
      }
    }
  }
}

template <int C, int IL, int FMT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    align_tiles_kernel(const Args a) {
  using R = Ring<C, FMT>;
  constexpr int NW = (C + 3) / 4;  // query words a strip
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = (blockIdx.x * (blockDim.x >> 5) + warp) * IL;
  if (b0 >= a.B) return;  // the whole warp
  const int T = a.T;
  const int tile_smem = R::kBytes + round16(T + 32);
  uint8_t* wsm = smem + static_cast<size_t>(warp) * IL * tile_smem;

  // Zero the rings; each tile's ref row follows its ring, with room for
  // the rows past the tile's last (up to T + 31).
  {
    uint4* z = reinterpret_cast<uint4*>(wsm);
    for (int x = lane; x < IL * tile_smem / 16; x += 32) {
      z[x] = make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < IL; ++k) {
      uint8_t* sref = wsm + k * tile_smem + R::kBytes;
      const uint8_t* g = a.ref + static_cast<size_t>(b0 + k) * T;
      for (int x = lane; x < T; x += 32) sref[x] = at(g, x);
    }
  }

  int rl[IL], qv[IL], last[IL], nvalid[IL], crow[IL], qloc[IL];
  unsigned qw[IL][NW];
  int emax = 0;
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    const int b = b0 + k;
    const int rlen = at(a.ref_len, b);
    const int qlen = at(a.query_len, b);
    rl[k] = max(0, min(rlen, T));
    qv[k] = max(0, min(qlen, T));
    last[k] = rl[k] > 0 ? min(rl[k] + Lag<FMT>::value, T) : 0;
    emax = max(emax, last[k]);
    nvalid[k] = max(0, min(qv[k] - lane * C, C));
    const bool corner = rlen >= 1 && rlen <= T && qlen >= 1 && qlen <= T;
    crow[k] = corner ? rlen : -1;
    qloc[k] = qlen - 1 - lane * C;
    const uint8_t* g = a.query + static_cast<size_t>(b) * T;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      unsigned v = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int x = lane * C + 4 * w + t;
        if (4 * w + t < C && x < T) {
          v |= static_cast<unsigned>(at(g, x)) << (8 * t);
        }
      }
      qw[k][w] = v;
    }
  }
  // Max-cell key offsets by strip column, one tile a warp: c, or c -
  // 2^30 past qlen, so that a column past qlen never wins a row.  With
  // more tiles a warp the registers are short, and the key is masked
  // cell by cell instead.
  int kcol[C];
#pragma unroll
  for (int c = 0; c < C; ++c) kcol[c] = c < nvalid[0] ? c : c - NEG_INF;
  __syncwarp();

  // The row above, per strip column: M + go, I + ge, H.
  int mgo_up[IL][C], ige_up[IL][C], h_up[IL][C];
  // This lane's last column, for lane + 1: M + go, D + ge of the row
  // just computed and H of the row before it.
  int out_mgo[IL], out_dge[IL], out_hd[IL];
  int best_h[IL], best_i[IL], best_c[IL], corner_h[IL];
#pragma unroll
  for (int k = 0; k < IL; ++k) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      mgo_up[k][c] = a.go;
      ige_up[k][c] = -NEG_INF + a.ge;
      h_up[k][c] = 0;
    }
    out_mgo[k] = a.go;
    out_dge[k] = -NEG_INF + a.ge;
    out_hd[k] = 0;
    best_h[k] = -1;
    best_i[k] = 0;
    best_c[k] = 0;
    corner_h[k] = 0;
  }

  const int sdiff = a.match - a.mismatch;
  const int steps = emax > 0 ? emax + 31 : 0;
  for (int s = 1; s <= steps; ++s) {
    const int i = s - lane;  // this lane's row
    int left_mgo[IL], left_dge[IL], left_hd[IL];
#pragma unroll
    for (int k = 0; k < IL; ++k) {
      left_mgo[k] = __shfl_up_sync(FULL, out_mgo[k], 1);
      left_dge[k] = __shfl_up_sync(FULL, out_dge[k], 1);
      left_hd[k] = __shfl_up_sync(FULL, out_hd[k], 1);
    }
    // Lanes wait for row 1 (step lane + 1); past the tile's last row
    // they run on, and the ring and the max cell ignore those rows.
    if (i >= 1) {
      const int slot = static_cast<unsigned>(i - 1) % R::kRows;
#pragma unroll
      for (int k = 0; k < IL; ++k) {
        int mgo = left_mgo[k], dge = left_dge[k], diag = left_hd[k];
        if (lane == 0) {  // column 0: M = 0, D = -NEG_INF, H = 0
          mgo = a.go;
          dge = -NEG_INF + a.ge;
          diag = 0;
        }
        uint8_t* tile = wsm + k * tile_smem;
        const unsigned rrep =
            static_cast<unsigned>(tile[R::kBytes + i - 1]) * 0x01010101u;
        unsigned eqw[NW];  // 1 in each byte whose query char is the ref's
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          eqw[w] = __vcmpeq4(qw[k][w], rrep) & 0x01010101u;
        }
        uint8_t* rowp = tile + slot * R::kRowBytes + kPadL + 1 + lane * C;
        int rowkey = -NEG_INF, pending = -NEG_INF;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          // The match flag as 0/1 (one byte permute), the score from it
          // by a multiply-add.
          const int eq = __byte_perm(eqw[c >> 2], 0, 0x4440 | (c & 3));
          const int m = __viaddmax_s32(diag, a.mismatch + eq * sdiff, 0);
          diag = h_up[k][c];
          bool open_i, open_d;
          const int ii = __vibmax_s32(mgo_up[k][c], ige_up[k][c], &open_i);
          const int d = __vibmax_s32(mgo, dge, &open_d);
          const int h = __vimax3_s32(m, ii, d);
          // Tie order m > i > d; m >= 0, so h == 0 only where m == h.
          const int op = m == h ? 3 * min(h, 1) : ii == h ? 2 : 1;
          rowp[c] = static_cast<uint8_t>(
              op + (open_i ? GAP_OPEN_FLAG_I : 0) +
              (open_d ? GAP_OPEN_FLAG_D : 0) + eq * MATCH_BIT);
          int key;
          if constexpr (IL == 1) {
            key = (h << 6) + kcol[c];
          } else {
            key = c < nvalid[k] ? (h << 6) | c : -NEG_INF;
          }
          if (c & 1) {
            rowkey = __vimax3_s32(rowkey, pending, key);
          } else {
            pending = key;
          }
          mgo = m + a.go;
          dge = d + a.ge;
          mgo_up[k][c] = mgo;
          ige_up[k][c] = ii + a.ge;
          h_up[k][c] = h;
        }
        if (C & 1) rowkey = max(rowkey, pending);
        out_mgo[k] = mgo;
        out_dge[k] = dge;
        out_hd[k] = diag;
        // Rows come in order, so >= keeps the row-major-last maximum; a
        // row past rlen, or with no column up to qlen, does not count.
        bool later;
        best_h[k] =
            __vibmax_s32(i <= rl[k] ? rowkey >> 6 : -2, best_h[k], &later);
        if (later) {
          best_i[k] = i;
          best_c[k] = rowkey & 63;
        }
        if (i == crow[k]) {  // h >= 0, and one c at most is qloc[k]
#pragma unroll
          for (int c = 0; c < C; ++c) {
            corner_h[k] |= c == qloc[k] ? h_up[k][c] : 0;
          }
        }
      }
    }
    __syncwarp();  // the ring's rows are complete up to row s - 31
    const int r = s - 31;
    if (r >= 1) {
      if constexpr (FMT != kBytes) {
        // Row r's columns past qlen go to 0 once, before any word reads
        // them (the lanes store every byte they compute).
#pragma unroll
        for (int k = 0; k < IL; ++k) {
          if (r <= rl[k]) {
            uint8_t* row = wsm + k * tile_smem +
                           (r - 1) % R::kRows * R::kRowBytes + kPadL;
            for (int x = qv[k] + 1 + lane; x <= 32 * C; x += 32) row[x] = 0;
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int k = 0; k < IL; ++k) {
        if (r <= last[k]) {
          emit_row<C, FMT>(a, b0 + k, r, wsm + k * tile_smem, rl[k], qv[k],
                           lane);
        }
      }
    }
  }

  // The rows after last[k] hold no byte of a valid row: all zero.
  const int TJ = T + 1;
  const size_t esize = FMT == kBytes ? 1 : 4;
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    const size_t from =
        (static_cast<size_t>(b0 + k) * T + last[k]) * TJ * esize;
    const size_t n = static_cast<size_t>(T - last[k]) * TJ * esize;
    zero_bytes(static_cast<uint8_t*>(a.dir) + from, n, lane);
    if (FMT == kPlane2) {
      zero_bytes(reinterpret_cast<uint8_t*>(a.dir2) + from, n, lane);
    }
  }

  // Row-major-last max cell: the largest (score, row, column) key over
  // the lanes; none (rlen <= 0 or qlen <= 0) reports (0, 0, 0).
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    long long key = best_h[k] >= 0
                        ? (static_cast<long long>(best_h[k]) << 32) |
                              (static_cast<long long>(best_i[k]) << 16) |
                              (lane * C + best_c[k] + 1)
                        : -1LL;
    int cor = corner_h[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      key = max(key, __shfl_xor_sync(FULL, key, o));
      cor = max(cor, __shfl_xor_sync(FULL, cor, o));
    }
    if (lane == 0) {
      const int b = b0 + k;
      const bool found = key >= 0;
      at(a.max_score, b) = found ? static_cast<int>(key >> 32) : 0;
      at(a.max_i, b) = found ? static_cast<int>((key >> 16) & 0xffff) : 0;
      at(a.max_j, b) = found ? static_cast<int>(key & 0xffff) : 0;
      at(a.pos_score, b) = cor;
    }
  }
}

template <int C, int IL, int FMT>
int launch(const Args& a, int warps, cudaStream_t stream) {
  const size_t per_warp =
      static_cast<size_t>(IL) * (Ring<C, FMT>::kBytes + round16(a.T + 32));
  warps = max(1, min(warps, kMaxWarps));
  while (warps > 1 && warps * per_warp > kMaxSmem) --warps;
  const size_t smem = warps * per_warp;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        align_tiles_kernel<C, IL, FMT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tile_warps = a.B / IL;
  align_tiles_kernel<C, IL, FMT>
      <<<(tile_warps + warps - 1) / warps, 32 * warps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The strip width for T: the least of 2, 4, 8, 10, 12 (and 16, 32 at
// one tile a warp) with 32 C >= T.  Four tiles a warp at C = 16 need
// more than 255 registers a thread and spill, so interleaved tiles stop
// at C = 12, T <= 384.
template <int IL, int FMT>
int by_strip(const Args& a, int warps, cudaStream_t s) {
  const int c = (a.T + 31) / 32;
  if (c <= 2) return launch<2, IL, FMT>(a, warps, s);
  if (c <= 4) return launch<4, IL, FMT>(a, warps, s);
  if (c <= 8) return launch<8, IL, FMT>(a, warps, s);
  if (c <= 10) return launch<10, IL, FMT>(a, warps, s);
  if (c <= 12) return launch<12, IL, FMT>(a, warps, s);
  if constexpr (IL == 1) {
    if (c <= 16) return launch<16, IL, FMT>(a, warps, s);
    if (c <= 32) return launch<32, IL, FMT>(a, warps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// fmt: 0 bytes (dir uint8), 1 packed, 2 packed6 (dir int32), 3 plane2
// (dir and dir2 int32; interleave 1 only).  interleave: 1, 2 or 4 tiles
// a warp; B % interleave == 0.  warps: warps a block (1..8).
extern "C" int dtt_align_tiles(const uint8_t* ref, const uint8_t* query,
                               const int* ref_len, const int* query_len,
                               int B, int T, int match, int mismatch,
                               int gap_open, int gap_extend, int fmt,
                               int interleave, int warps, void* dir,
                               int* dir2, int* max_score, int* max_i,
                               int* max_j, int* pos_score, void* stream) {
  if (B <= 0 || T < 1 || B % interleave != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{ref,      query,    ref_len,  query_len, B,
               T,        match,    mismatch, gap_open,  gap_extend,
               dir,      dir2,     max_score, max_i,    max_j,
               pos_score};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(s);
  switch (fmt * 8 + interleave) {
    case kBytes * 8 + 1: return by_strip<1, kBytes>(a, warps, s);
    case kBytes * 8 + 2: return by_strip<2, kBytes>(a, warps, s);
    case kBytes * 8 + 4: return by_strip<4, kBytes>(a, warps, s);
    case kPacked * 8 + 1: return by_strip<1, kPacked>(a, warps, s);
    case kPacked * 8 + 2: return by_strip<2, kPacked>(a, warps, s);
    case kPacked * 8 + 4: return by_strip<4, kPacked>(a, warps, s);
    case kPacked6 * 8 + 1: return by_strip<1, kPacked6>(a, warps, s);
    case kPacked6 * 8 + 2: return by_strip<2, kPacked6>(a, warps, s);
    case kPacked6 * 8 + 4: return by_strip<4, kPacked6>(a, warps, s);
    case kPlane2 * 8 + 1: return by_strip<1, kPlane2>(a, warps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
