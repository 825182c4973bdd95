// GACT tile DP for Hopper (sm_90a), in four output formats, with one,
// two or four tiles a warp, for T up to 2048 (the reference's
// MAX_TILE_SIZE 2049, align.h:19, less one).
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
//
// The split path, past the one-warp path's T (C = 32, T <= 1023, at one
// tile a warp; C = 12, T <= 384, at two or four): one block of S warps
// holds a tile (IL tiles), warp w the strip of columns 32Cw + 1 ..
// 32C(w + 1): S = ceil(T / 512) (T / 256 interleaved), so S = 2..4
// (2..8), and C the least of 8, 12, 16 (only 8 interleaved) with
// 32 C S >= T.  Each warp runs the wavefront above over its strip, 31 + 8
// steps behind its left neighbour, whose lane 31 hands lane 0 the left
// boundary of each row through a ring in shared memory (with the
// neighbour's last four direction bytes, which the word formats read);
// a block barrier every 8 steps orders the ring, as in csrc/swscore.cu.
// Direction rows go out by groups of 16 lanes, each from a ring of its
// own of 16 + 1 + lag rows, so that one row of T bytes is not held a
// whole warp's 32 steps.  At T = 2048 in packed6 the rings of a tile
// take 44,416 bytes (C = 16), those of four interleaved tiles (C = 8)
// 183,296, and with the ref rows and the boundary rings 208,384 of the
// 232,448 a block may have (kMaxSmem; whole-warp rings would take
// 312,576).  The max cell is reduced over the lanes, then the warps,
// through shared memory (its key keeps the column in 16 bits).  Outputs
// are the one-warp path's, bit for bit; ops/dp.py picks the path, S
// and C.
//
// The 16-bit split path, two tiles a block in the 16-bit halves of the
// registers, which ops/dp.py takes at interleave 1 in bytes, packed and
// packed6 where the scores stay clear of a 16-bit sentinel, is
// csrc/dp16.cu (its own source, so that nvcc builds it beside this one).

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "checked.cuh"
#include "dp_common.cuh"

namespace {

// The one-warp path's ring: the whole warp is one group.
template <int C, int FMT> using Ring = RingOf<32, C, FMT>;

// Row x of a ring at its column 0: DP row x for 1 <= x <= rl, else
// the zero row (row 0 and the rows past rlen hold no direction byte).
template <class R>
__device__ __forceinline__ const uint8_t* ring_row(const uint8_t* ring,
                                                   int x, int rl) {
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

// The warp writes columns c0 .. c0+n-1 of DP row r (1-based) of tile b
// from a ring whose column 0 is column c0: bytes with their columns past
// qv = min(qlen, T) as 0; words from ring rows that hold zeros past qv
// already.  Rows past rl read as the zero row.
template <class R, int FMT>
__device__ __forceinline__ void emit_row(const Args& a, int b, int r,
                                         const uint8_t* ring, int rl,
                                         int qv, int lane, int c0, int n) {
  const int TJ = a.T + 1;
  const size_t off = (static_cast<size_t>(b) * a.T + (r - 1)) * TJ + c0;
  const uint8_t* r0 = ring_row<R>(ring, r, rl);
  if constexpr (FMT == kBytes) {
    copy_row(static_cast<uint8_t*>(a.dir) + off, r0, n, qv - c0, lane);
  } else {
    const uint8_t* r1 = ring_row<R>(ring, r - 1, rl);
    int* words = static_cast<int*>(a.dir) + off;
    // Every field's column lies in c - 3 .. c + 1 (kPadL columns on the
    // left, zero columns past qlen on the right).
    for (int c = lane; c < n; c += 32) {
      if constexpr (FMT == kPacked) {
        at(words, c) = r0[c] | r0[c + 1] << 8 | r1[c] << 16 | r1[c + 1] << 24;
      } else {
        const uint8_t* r2 = ring_row<R>(ring, r - 2, rl);
        const uint8_t* r3 = ring_row<R>(ring, r - 3, rl);
        at(words, c) = r0[c] | r0[c + 1] << 5 | r1[c] << 10 |
                       r1[c + 1] << 15 | r2[c - 1] << 20 | r3[c - 2] << 25;
        if constexpr (FMT == kPlane2) {
          at(a.dir2, off + c) = ring_row<R>(ring, r - 4, rl)[c - 2] |
                                ring_row<R>(ring, r - 5, rl)[c - 2] << 5 |
                                ring_row<R>(ring, r - 6, rl)[c - 3] << 10;
        }
      }
    }
  }
}

// The C cells of one row of a lane's strip, ref byte rrep (x
// 0x01010101) against the query words qw: updates the row-above state
// (mgo_up, ige_up, h_up) in place, stores each direction byte at
// rowp[c], and returns the row's best max-cell key (h * 64 + column,
// columns past qlen below zero).  mgo, dge and diag come in as the left
// boundary and go out as the lane's last column's, for lane + 1.
template <int C, int IL>
__device__ __forceinline__ int row_cells(
    const Args& a, int sdiff, const unsigned (&qw)[(C + 3) / 4],
    unsigned rrep, const int (&kcol)[C], int nvalid, int (&mgo_up)[C],
    int (&ige_up)[C], int (&h_up)[C], uint8_t* rowp, int& mgo, int& dge,
    int& diag) {
  constexpr int NW = (C + 3) / 4;
  unsigned eqw[NW];  // 1 in each byte whose query char is the ref's
#pragma unroll
  for (int w = 0; w < NW; ++w) eqw[w] = __vcmpeq4(qw[w], rrep) & 0x01010101u;
  int rowkey = -NEG_INF, pending = -NEG_INF;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // The match flag as 0/1 (one byte permute), the score from it by a
    // multiply-add.
    const int eq = __byte_perm(eqw[c >> 2], 0, 0x4440 | (c & 3));
    const int m = __viaddmax_s32(diag, a.mismatch + eq * sdiff, 0);
    diag = h_up[c];
    bool open_i, open_d;
    const int ii = __vibmax_s32(mgo_up[c], ige_up[c], &open_i);
    const int d = __vibmax_s32(mgo, dge, &open_d);
    const int h = __vimax3_s32(m, ii, d);
    // Tie order m > i > d; m >= 0, so h == 0 only where m == h.
    const int op = m == h ? 3 * min(h, 1) : ii == h ? 2 : 1;
    rowp[c] = static_cast<uint8_t>(op + (open_i ? GAP_OPEN_FLAG_I : 0) +
                                   (open_d ? GAP_OPEN_FLAG_D : 0) +
                                   eq * MATCH_BIT);
    int key;
    if constexpr (IL == 1) {
      key = (h << 6) + kcol[c];
    } else {
      key = c < nvalid ? (h << 6) | c : -NEG_INF;
    }
    if (c & 1) {
      rowkey = __vimax3_s32(rowkey, pending, key);
    } else {
      pending = key;
    }
    mgo = m + a.go;
    dge = d + a.ge;
    mgo_up[c] = mgo;
    ige_up[c] = ii + a.ge;
    h_up[c] = h;
  }
  if (C & 1) rowkey = max(rowkey, pending);
  return rowkey;
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
        uint8_t* rowp = tile + slot * R::kRowBytes + kPadL + 1 + lane * C;
        const int rowkey = row_cells<C, IL>(
            a, sdiff, qw[k], rrep, kcol, nvalid[k], mgo_up[k], ige_up[k],
            h_up[k], rowp, mgo, dge, diag);
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
          emit_row<R, FMT>(a, b0 + k, r, wsm + k * tile_smem, rl[k], qv[k],
                           lane, 0, T + 1);
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

// The split path: one tile (IL tiles) a block of S warps.  Warp w owns
// columns 32Cw + 1 .. 32C(w + 1) and runs the one-warp path's wavefront
// over them kLag steps behind warp w - 1; its lane 0 takes the left
// boundary of row i (M + go, D + ge, H of the row above, and the four
// direction bytes left of the strip) from a ring of kBnd entries that
// lane 31 of warp w - 1 fills, and the block meets at a barrier every
// kSync steps, which orders each entry's write before its read (kLag =
// 31 + kSync) and its read before the slot is written again (kBnd >=
// 2 kSync).  Rows are emitted by groups of kGroup lanes, each from a ring
// of its own, so that only kGroup + 1 + lag rows of a group are in
// flight.
// A group emits the columns from its left neighbour's last (its column
// 0, whose direction bytes and those of the three columns left of it
// the neighbour hands over into the ring's kPadL columns) to the one
// before its own last, and the tile's last group up to T: every word's
// columns c - 3 .. c + 1 then lie in the ring of the group that writes
// it.  split_smem gives the budget (the file's head comment).

template <int C, int FMT> using GroupRing = RingOf<kGroup, C, FMT>;

// Shared memory of a split block: per tile the S * 32 / kGroup group
// rings and the ref row; then the boundary rings [S][IL] x kBnd int4 and
// the max-cell reduction's [IL][S] keys and corner scores.
template <int C, int IL, int FMT>
__host__ __device__ constexpr size_t split_tile_bytes(int S, int T) {
  return static_cast<size_t>(S) * (32 / kGroup) *
             GroupRing<C, FMT>::kBytes +
         round16(T + 32);
}
template <int C, int IL, int FMT>
__host__ __device__ constexpr size_t split_smem(int S, int T) {
  return IL * split_tile_bytes<C, IL, FMT>(S, T) +
         static_cast<size_t>(S) * IL *
             (kBnd * sizeof(int4) + sizeof(long long) + sizeof(int));
}

// Stores the four bytes of v at p .. p + 3 (p any alignment).
__device__ __forceinline__ void put4(uint8_t* p, unsigned v) {
#pragma unroll
  for (int t = 0; t < 4; ++t) p[t] = static_cast<uint8_t>(v >> (8 * t));
}

// One block a multiprocessor at least: ptxas then keeps two tiles a warp
// at C = 8 in registers (at its own choice of 128 it spilled them).
template <int C, int IL, int FMT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    align_tiles_split(const Args a) {
  using R = GroupRing<C, FMT>;
  constexpr int NW = (C + 3) / 4;  // query words a strip
  constexpr int GW = 32 / kGroup;  // groups a warp
  constexpr int GC = kGroup * C;   // columns a group
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S = blockDim.x >> 5;
  const int sl = lane % kGroup;    // lane in its group
  const int b0 = blockIdx.x * IL;
  const int T = a.T;
  const int jw = warp * 32 * C;    // columns left of this warp's strip
  const int jl = jw + lane * C;    // columns left of this lane's
  const size_t tile_smem = split_tile_bytes<C, IL, FMT>(S, T);
  int4* bnd = reinterpret_cast<int4*>(smem + IL * tile_smem);
  long long* red_key = reinterpret_cast<long long*>(bnd + S * IL * kBnd);
  int* red_cor = reinterpret_cast<int*>(red_key + IL * S);
  // Group q of this warp's ring for tile k, and tile k's ref row.
  auto ring = [&](int k, int q) {
    return smem + k * tile_smem + (warp * GW + q) * R::kBytes;
  };
  auto sref = [&](int k) {
    return smem + k * tile_smem + S * GW * R::kBytes;
  };

  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n16 = static_cast<int>(split_smem<C, IL, FMT>(S, T) / 16);
    for (int x = threadIdx.x; x < n16; x += blockDim.x) {
      z[x] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < IL; ++k) {
      const uint8_t* g = a.ref + static_cast<size_t>(b0 + k) * T;
      for (int x = threadIdx.x; x < T; x += blockDim.x) sref(k)[x] = at(g, x);
    }
    __syncthreads();
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
    nvalid[k] = max(0, min(qv[k] - jl, C));
    const bool corner = rlen >= 1 && rlen <= T && qlen >= 1 && qlen <= T;
    crow[k] = corner ? rlen : -1;
    qloc[k] = qlen - 1 - jl;
    const uint8_t* g = a.query + static_cast<size_t>(b) * T;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      unsigned v = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int x = jl + 4 * w + t;
        if (4 * w + t < C && x < T) {
          v |= static_cast<unsigned>(at(g, x)) << (8 * t);
        }
      }
      qw[k][w] = v;
    }
  }
  int kcol[C];
#pragma unroll
  for (int c = 0; c < C; ++c) kcol[c] = c < nvalid[0] ? c : c - NEG_INF;

  int mgo_up[IL][C], ige_up[IL][C], h_up[IL][C];
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
  const int total = steps > 0 ? steps + (S - 1) * kLag : 0;
  for (int g = 1; g <= total; ++g) {
    const int s = g - warp * kLag;  // this warp's step
    if (s >= 1 && s <= steps) {
      const int i = s - lane;  // this lane's row
      int left_mgo[IL], left_dge[IL], left_hd[IL];
#pragma unroll
      for (int k = 0; k < IL; ++k) {
        left_mgo[k] = __shfl_up_sync(FULL, out_mgo[k], 1);
        left_dge[k] = __shfl_up_sync(FULL, out_dge[k], 1);
        left_hd[k] = __shfl_up_sync(FULL, out_hd[k], 1);
      }
      if (i >= 1) {
        const int slot = static_cast<unsigned>(i - 1) % R::kRows;
        const int bslot = i & (kBnd - 1);
#pragma unroll
        for (int k = 0; k < IL; ++k) {
          int mgo = left_mgo[k], dge = left_dge[k], diag = left_hd[k];
          uint8_t* gring = ring(k, lane / kGroup);
          if (lane == 0) {
            if (warp == 0) {  // column 0: M = 0, D = -NEG_INF, H = 0
              mgo = a.go;
              dge = -NEG_INF + a.ge;
              diag = 0;
            } else {
              const int4 v = bnd[(warp * IL + k) * kBnd + bslot];
              mgo = v.x;
              dge = v.y;
              diag = v.z;
              put4(gring + slot * R::kRowBytes + kPadL - 3,
                   static_cast<unsigned>(v.w));
            }
          }
          const unsigned rrep =
              static_cast<unsigned>(sref(k)[i - 1]) * 0x01010101u;
          uint8_t* rowp = gring + slot * R::kRowBytes + kPadL + 1 + sl * C;
          const int rowkey = row_cells<C, IL>(
              a, sdiff, qw[k], rrep, kcol, nvalid[k], mgo_up[k], ige_up[k],
              h_up[k], rowp, mgo, dge, diag);
          out_mgo[k] = mgo;
          out_dge[k] = dge;
          out_hd[k] = diag;
          // A group's last lane hands its last four bytes to the next
          // group: within the warp into that group's ring, across warps
          // with the boundary.
          if (sl == kGroup - 1) {
            const uint8_t* e = rowp + C - 4;
            if (lane < 31) {
              uint8_t* nx = ring(k, lane / kGroup + 1) +
                            slot * R::kRowBytes + kPadL - 3;
#pragma unroll
              for (int t = 0; t < 4; ++t) nx[t] = e[t];
            } else if (warp + 1 < S) {
              const unsigned w4 = e[0] | e[1] << 8 | e[2] << 16 | e[3] << 24;
              bnd[((warp + 1) * IL + k) * kBnd + bslot] =
                  make_int4(mgo, dge, diag, static_cast<int>(w4));
            }
          }
          bool later;
          best_h[k] =
              __vibmax_s32(i <= rl[k] ? rowkey >> 6 : -2, best_h[k], &later);
          if (later) {
            best_i[k] = i;
            best_c[k] = rowkey & 63;
          }
          if (i == crow[k]) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              corner_h[k] |= c == qloc[k] ? h_up[k][c] : 0;
            }
          }
        }
      }
      __syncwarp();  // group q's rows are complete up to s + 1 - 16(q + 1)
#pragma unroll
      for (int q = 0; q < GW; ++q) {
        const int r = s + 1 - kGroup * (q + 1);
        const int c0 = jw + q * GC;  // the group's column 0
        if (r < 1 || c0 > T) continue;
        const bool tail = warp == S - 1 && q == GW - 1;
        const int n = tail ? T - c0 + 1 : min(GC, T - c0 + 1);
        if constexpr (FMT != kBytes) {
          // Row r's columns past qlen, and the handed-over ones, go to 0
          // once, before any word reads them.
#pragma unroll
          for (int k = 0; k < IL; ++k) {
            if (r <= rl[k]) {
              uint8_t* row = ring(k, q) + (r - 1) % R::kRows * R::kRowBytes +
                             kPadL;
              for (int x = max(qv[k] - c0 + 1, -3) + lane; x <= GC; x += 32) {
                row[x] = 0;
              }
            }
          }
          __syncwarp();
        }
#pragma unroll
        for (int k = 0; k < IL; ++k) {
          if (r <= last[k]) {
            emit_row<R, FMT>(a, b0 + k, r, ring(k, q), rl[k], qv[k], lane,
                             c0, n);
          }
        }
      }
    }
    if (g % kSync == 0) __syncthreads();
  }

  // The rows after last[k]: zero, each warp one S-th of them.
  const int TJ = T + 1;
  const size_t esize = FMT == kBytes ? 1 : 4;
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    const size_t from =
        (static_cast<size_t>(b0 + k) * T + last[k]) * TJ * esize;
    const size_t n = static_cast<size_t>(T - last[k]) * TJ * esize;
    const size_t lo = n * warp / S, hi = n * (warp + 1) / S;
    zero_bytes(static_cast<uint8_t*>(a.dir) + from + lo, hi - lo, lane);
    if (FMT == kPlane2) {
      zero_bytes(reinterpret_cast<uint8_t*>(a.dir2) + from + lo, hi - lo,
                 lane);
    }
  }

  // Row-major-last max cell over the lanes, then over the warps.
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    long long key = best_h[k] >= 0
                        ? (static_cast<long long>(best_h[k]) << 32) |
                              (static_cast<long long>(best_i[k]) << 16) |
                              (jl + best_c[k] + 1)
                        : -1LL;
    int cor = corner_h[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      key = max(key, __shfl_xor_sync(FULL, key, o));
      cor = max(cor, __shfl_xor_sync(FULL, cor, o));
    }
    if (lane == 0) {
      red_key[k * S + warp] = key;
      red_cor[k * S + warp] = cor;
    }
  }
  __syncthreads();
  if (threadIdx.x < IL) {
    const int k = threadIdx.x;
    long long key = -1LL;
    int cor = 0;
    for (int w = 0; w < S; ++w) {
      key = max(key, red_key[k * S + w]);
      cor = max(cor, red_cor[k * S + w]);
    }
    const int b = b0 + k;
    const bool found = key >= 0;
    at(a.max_score, b) = found ? static_cast<int>(key >> 32) : 0;
    at(a.max_i, b) = found ? static_cast<int>((key >> 16) & 0xffff) : 0;
    at(a.max_j, b) = found ? static_cast<int>(key & 0xffff) : 0;
    at(a.pos_score, b) = cor;
  }
}

template <int C, int IL, int FMT>
int launch_split(const Args& a, int strips, cudaStream_t stream) {
  const size_t smem = split_smem<C, IL, FMT>(strips, a.T);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        align_tiles_split<C, IL, FMT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  align_tiles_split<C, IL, FMT>
      <<<a.B / IL, 32 * strips, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The split path at the strip width `width` that ops/dp.py picks (the
// least with 32 C S >= T): C = 8, 12 or 16 at one tile a warp, 8
// interleaved, which keeps four tiles' registers below the spill and
// their rings inside kMaxSmem at T = 2048 (S = 8).  Any other width, or
// one whose strips do not cover T, is an error.
template <int IL, int FMT>
int by_split(const Args& a, int strips, int width, cudaStream_t s) {
  if (strips < 2 || strips > kMaxWarps || 32 * width * strips < a.T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (width == 8) return launch_split<8, IL, FMT>(a, strips, s);
  if constexpr (IL == 1) {
    if (width == 12) return launch_split<12, IL, FMT>(a, strips, s);
    if (width == 16) return launch_split<16, IL, FMT>(a, strips, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// fmt: 0 bytes (dir uint8), 1 packed, 2 packed6 (dir int32), 3 plane2
// (dir and dir2 int32; interleave 1 only).  interleave: 1, 2 or 4 tiles
// a warp; B % interleave == 0.  strips: 1 for the one-warp path, `warps`
// warps (1..8) a block; 2..8 for the split path, one block of `strips`
// warps a tile, each lane holding `width` columns (ops/dp.py picks both;
// width is unused on the one-warp path).  The 16-bit split path has its
// own entry, dtt_align_tiles16 (csrc/dp16.cu).
extern "C" int dtt_align_tiles(const uint8_t* ref, const uint8_t* query,
                               const int* ref_len, const int* query_len,
                               int B, int T, int match, int mismatch,
                               int gap_open, int gap_extend, int fmt,
                               int interleave, int warps, int strips,
                               int width, void* dir, int* dir2,
                               int* max_score, int* max_i, int* max_j,
                               int* pos_score, void* stream) {
  if (B <= 0 || T < 1 || B % interleave != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{ref,      query,    ref_len,  query_len, B,
               T,        match,    mismatch, gap_open,  gap_extend,
               dir,      dir2,     max_score, max_i,    max_j,
               pos_score};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(s);
  const auto run = [&](auto il, auto f) {
    constexpr int IL = decltype(il)::value, FMT = decltype(f)::value;
    return strips == 1 ? by_strip<IL, FMT>(a, warps, s)
                       : by_split<IL, FMT>(a, strips, width, s);
  };
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  using FB = std::integral_constant<int, kBytes>;
  using FP = std::integral_constant<int, kPacked>;
  using F6 = std::integral_constant<int, kPacked6>;
  using F2 = std::integral_constant<int, kPlane2>;
  switch (fmt * 8 + interleave) {
    case kBytes * 8 + 1: return run(I1{}, FB{});
    case kBytes * 8 + 2: return run(I2{}, FB{});
    case kBytes * 8 + 4: return run(I4{}, FB{});
    case kPacked * 8 + 1: return run(I1{}, FP{});
    case kPacked * 8 + 2: return run(I2{}, FP{});
    case kPacked * 8 + 4: return run(I4{}, FP{});
    case kPacked6 * 8 + 1: return run(I1{}, F6{});
    case kPacked6 * 8 + 2: return run(I2{}, F6{});
    case kPacked6 * 8 + 4: return run(I4{}, F6{});
    case kPlane2 * 8 + 1: return run(I1{}, F2{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
