// GACT tile DP for Hopper (sm_90a), the 16-bit split path: tiles of T =
// 385 .. 2048 (and any T its strips cover) over one block of S warps,
// two tiles a block, tile 2p in the low and 2p + 1 in the high 16-bit
// half of every state register, in bytes, packed, packed6 and plane 2.
//
// Replaces, like csrc/dp.cu's split path, darwin_tpu/ops/pallas_dp.py::
// align_tiles_pallas's interleave=1 pallas_call (line 523) and its
// interleave>1 stream pallas_call (line 493, _make_stream_kernel: IL
// independent batch streams a grid step, bit-identical for every IL),
// and tools/plane2_probe.py's kernel (the pallas_call at line 209,
// kernel2); contract darwin_tpu/ops/reference_dp.py::align_tiles_jax
// (its port darwin_tpu_torch/ops/reference_dp.py), the word formats
// through darwin_tpu_torch/ops/pack.py.  The TPU's streams hide a row's
// latency; here every interleave runs this one kernel, since a pair of
// tiles a lane already interleaves two tiles' cells (the outputs are per
// tile, so any pairing is right; two pairs a lane ran slower, PERF.md
// section 6).  darwin_tpu keeps its state in int32
// only because the v5e VPU rejects 16-bit comparisons
// (pallas_dp.py _score_dtype); its bound on the scores and its 16-bit
// sentinel NEG16 are the gate ops/dp.py applies before it launches this
// kernel (fits_int16), so the outputs are csrc/dp.cu's int32 split
// kernel's, bit for bit.  The layout is that kernel's (csrc/dp.cu's head
// comment); what differs, and why, is below.

#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"
#include "dp_common.cuh"

namespace {

template <int C, int FMT> using GroupRing16 = RingOf<kGroup, C, FMT, 1>;

// The 16-bit split path: csrc/dp.cu's split path, two tiles a block,
// tile 2p in the low 16-bit half of every state register and tile 2p + 1 in
// the high half, so that one DPX instruction of the s16x2 forms does a
// cell of each.  ops/dp.py takes it where the scores of a T x T tile are
// bounded clear of the 16-bit sentinel kNeg16 (darwin_tpu's NEG16,
// pallas_dp.py:56, and its bound, _score_dtype); every real value then
// lies in (kNeg16 + ge, -kNeg16) and the sentinel compares as the int32
// path's -(1 << 30) does, so the outputs are the int32 path's, bit for
// bit.  Columns past qlen and rows past rlen may wrap: nothing of them
// reaches an output (their direction bytes and max-cell keys are
// masked, and they feed only cells right of or below them).
//
// A cell pair: the match flags from the pair's query characters x the
// row's ref characters (one xor, one min: 0 where equal, else 1), the
// score pair from them by one multiply-add (scoring constants chosen so
// that no carry crosses the halves, Pair16), M by __viaddmax_s16x2_relu,
// I and D by max.s16x2, H by __vimax3_s16x2.  The direction byte's open
// flags and the op's tie order m > i > d come from equality flags of
// the pairs (an xor and a min each, row_cells16), not from predicates:
// a predicate costs an instruction a half to reach a register, an
// equality flag one instruction a pair.  The direction bytes of four
// columns go to each tile's ring as one 32-bit store (__byte_perm
// splits the pairs).  The max-cell key of each tile stays 32-bit (h in
// the high 16 bits, the column below, bit 31 set past qlen): h reaches
// 19999 at the gate's edge, so h * C + column would not fit 16 bits.
//
// On the card the rows' emission takes as much time as the cells or
// more (PERF.md section 6): its loads wait on shared memory, and a warp
// that emits after its row leaves the integer units idle.  So a group
// emits a row one step after it completes it, before the next row, with
// no branch between the two in the steady steps (bytes: copy_row_at
// clamps its loads and predicates its stores), so that the emission
// issues among the row's arithmetic.
//
// The split's own overhead: every lane reads the boundary entry as a
// broadcast and lane 0 selects it (warp 0 reads a ring that holds column
// 0's values); the four handed-over direction bytes a tile are one
// aligned 32-bit store, column 1 of a ring row starting 4-aligned at its
// byte 4 (column 0 at byte kOff16).  Warps meet their neighbours only,
// through named barriers every kSync steps: warp w waits for warp w - 1
// (kFull) and tells it what it has read (kEmpty), and warp w - 1 waits
// for that one phase later, so that it never runs more than two phases
// ahead (the boundary ring's kBnd >= 24 slots cover that).
constexpr int kNeg16 = -20000;
constexpr int kOff16 = 3;
constexpr int kFullBar = 1;                  // + w: warp w - 1 -> w
constexpr int kEmptyBar = kFullBar + kMaxWarps - 1;  // + w: w -> w - 1

// The scoring in pair form.  sc = ne * mul + mat gives each half match
// (ne 0) or mismatch (ne 1): mul is the difference mod 2^16 less the
// carry that the low half's sum would push into the high half.
struct Pair16 {
  unsigned go, ge, neg_ge, mat, mul;
};
__device__ __forceinline__ unsigned pair16(int v) {
  return (static_cast<unsigned>(v) & 0xffffu) * 0x10001u;
}
__device__ __forceinline__ Pair16 pair_scoring(const Args& a) {
  const unsigned m16 = static_cast<unsigned>(a.mismatch - a.match) & 0xffffu;
  const unsigned carry =
      ((static_cast<unsigned>(a.match) & 0xffffu) + m16) >> 16;
  return Pair16{pair16(a.go), pair16(a.ge), pair16(kNeg16 + a.ge),
                pair16(a.match), m16 - (carry << 16)};
}

// Per-half (16x2) integer operations of sm_90, one instruction each.
__device__ __forceinline__ unsigned add16(unsigned a, unsigned b) {
  unsigned r;
  asm("add.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned max16(unsigned a, unsigned b) {
  unsigned r;
  asm("max.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// Per half 0 where x is 0, else 1 (x unsigned; the second x saves a
// register for the constant).
__device__ __forceinline__ unsigned nz16(unsigned x) {
  return __vimin3_u16x2(x, 0x00010001u, x);
}

// One row of a lane's strip for both tiles: rp holds the row's ref
// characters (low, high), qp[c] the column's query characters.  Updates
// the row-above state in place, stores the direction bytes of each tile
// (four columns a 32-bit word) at rowlo / rowhi and returns the last
// word of each in dlo / dhi, and each tile's best max-cell key of the
// row in key_lo / key_hi (negative when no column is up to qlen).  mgo,
// dge and diag come in as the left boundary and go out as the lane's
// last column's.
//
// The direction byte is arithmetic on 0/1 flags, both halves at once:
// nz16 of an xor is 1 where two values differ, so with ne (the
// characters differ), ni (ii != M + go: I extended), nd (d != M + go:
// D extended), a (m != h) and b (ii != h), each half is
//   16 (1 - ne) + 8 (1 - ni) + 4 (1 - nd) + op,
//   op = 3 hpos - a - (a & b): 3 where m wins, 2 where ii does, else 1,
// and 0 where h == 0 (hpos = min(h, 1); h == 0 means m == h, so a = 0).
// Each half's sum lies in 0..31, so no borrow or carry crosses them.
template <int C>
__device__ __forceinline__ void row_cells16(
    const Pair16& k, unsigned rp, const unsigned (&qp)[C],
    const unsigned (&klo)[C], const unsigned (&khi)[C],
    unsigned (&mgo_up)[C], unsigned (&ige_up)[C], unsigned (&h_up)[C],
    uint32_t* rowlo, uint32_t* rowhi, unsigned& mgo, unsigned& dge,
    unsigned& diag, int& key_lo, int& key_hi, unsigned& dlo,
    unsigned& dhi) {
  unsigned dq[4];
  int plo = 0, phi = 0;
  key_lo = key_hi = INT32_MIN;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const unsigned ne = nz16(qp[c] ^ rp);
    // M = max(diag + s, s, 0) = max(diag + s, 0), as diag >= 0.
    const unsigned sc = ne * k.mul + k.mat;
    const unsigned m = __viaddmax_s16x2_relu(diag, sc, sc);
    diag = h_up[c];
    const unsigned ii = max16(mgo_up[c], ige_up[c]);
    const unsigned d = max16(mgo, dge);
    const unsigned h = __vimax3_s16x2(m, ii, d);
    const unsigned a = nz16(m ^ h);
    unsigned dir = 0x001c001cu - 16u * ne - 8u * nz16(ii ^ mgo_up[c]) -
                   4u * nz16(d ^ mgo) + 3u * nz16(h);
    dir -= a + (a & nz16(ii ^ h));
    const int kl = static_cast<int>((h << 16) | klo[c]);
    const int kh = static_cast<int>((h & 0xffff0000u) | khi[c]);
    if (c & 1) {
      key_lo = __vimax3_s32(key_lo, plo, kl);
      key_hi = __vimax3_s32(key_hi, phi, kh);
    } else {
      plo = kl;
      phi = kh;
    }
    mgo = add16(m, k.go);
    dge = add16(d, k.ge);
    mgo_up[c] = mgo;
    ige_up[c] = add16(ii, k.ge);
    h_up[c] = h;
    dq[c & 3] = dir;
    if ((c & 3) == 3) {
      const unsigned x01 = __byte_perm(dq[0], dq[1], 0x6240);
      const unsigned x23 = __byte_perm(dq[2], dq[3], 0x6240);
      dlo = __byte_perm(x01, x23, 0x5410);
      dhi = __byte_perm(x01, x23, 0x7632);
      rowlo[c >> 2] = dlo;
      rowhi[c >> 2] = dhi;
    }
  }
}

// Where on, the warp copies columns 0 .. n-1 (n <= MAXN) of a ring row
// (16-aligned base rb, column 0 at byte OFF, readable 4 bytes past column
// n + 2) to global dst (any alignment), the columns past qv as 0:
// copy_row with the source's own misalignment, with no branch: every
// load is clamped into the row and only the stores are predicated, so
// that the copy's loads and stores can issue among the arithmetic of
// the row its warp computes next.
template <int OFF, int MAXN>
__device__ __forceinline__ void copy_row_at(bool on, uint8_t* dst,
                                            const uint8_t* rb, int n, int qv,
                                            int lane) {
  const int h = min((4 - static_cast<int>(
                              reinterpret_cast<uintptr_t>(dst) & 3)) & 3, n);
  const uint8_t head = rb[OFF + min(lane, 3)];
  if (on && lane < h) at(dst, lane) = lane <= qv ? head : 0;
  const int nw = (n - h) >> 2;
  uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + h);
  const int o = OFF + h;  // ring byte of d32[0]'s first column
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(rb) + (o >> 2);
  const int sh = 8 * (o & 3);
#pragma unroll
  for (int j = 0; j < (MAXN / 4 + 31) / 32; ++j) {
    const int x = lane + 32 * j;
    const int xc = min(x, MAXN / 4);  // a load inside the row
    uint32_t w = __funnelshift_r(s32[xc], s32[xc + 1], sh);
    const int nv = qv - (h + 4 * x) + 1;  // the word's bytes up to qv
    if (nv < 4) w = nv <= 0 ? 0 : w & ((1u << (8 * nv)) - 1);
    if (on && x < nw) at(d32, x) = w;
  }
  const int x = h + 4 * nw + lane;  // the tail: 3 bytes at most
  const uint8_t tail = rb[OFF + min(x, MAXN)];
  if (on && x < n) at(dst, x) = x <= qv ? tail : 0;
}

// Ring row x (column 0 at byte kOff16): DP row x for 1 <= x <= rl, else
// the zero row.
template <class R>
__device__ __forceinline__ const uint8_t* ring_row16(const uint8_t* ring,
                                                     int x, int rl) {
  const int slot = x >= 1 && x <= rl ? (x - 1) % R::kRows : R::kRows;
  return ring + slot * R::kRowBytes;
}

// The packed / packed6 word of column c from ring rows p[0] (row r) ..
// p[3] (row r - 3), each at its column 0.
template <int FMT, int N>
__device__ __forceinline__ int ring_word(const uint8_t* const (&p)[N],
                                         int c) {
  if constexpr (FMT == kPacked) {
    return p[0][c] | p[0][c + 1] << 8 | p[1][c] << 16 | p[1][c + 1] << 24;
  } else {
    return p[0][c] | p[0][c + 1] << 5 | p[1][c] << 10 | p[1][c + 1] << 15 |
           p[2][c - 1] << 20 | p[3][c - 2] << 25;
  }
}

// Bytes o .. o + 3 of a 4-aligned ring row q (v0) and o + 1 .. o + 4
// (v1), from two 32-bit loads.
__device__ __forceinline__ void bytes4(const uint8_t* q, int o, unsigned& v0,
                                       unsigned& v1) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(q) + (o >> 2);
  const uint32_t lo = w[0], hi = w[1];
  v0 = __funnelshift_r(lo, hi, 8 * (o & 3));
  v1 = __funnelshift_rc(lo, hi, 8 * (o & 3) + 8);
}

// The packed words of columns c .. c + 3 from byte vectors of their
// fields: v[0] row r's columns c .. c + 3, v[1] its c + 1 .. c + 4, v[2]
// and v[3] the same of row r - 1.
__device__ __forceinline__ void packed4(const unsigned (&v)[4],
                                       unsigned (&w)[4]) {
  const unsigned x01 = __byte_perm(v[0], v[1], 0x5140);
  const unsigned y01 = __byte_perm(v[2], v[3], 0x5140);
  const unsigned x23 = __byte_perm(v[0], v[1], 0x7362);
  const unsigned y23 = __byte_perm(v[2], v[3], 0x7362);
  w[0] = __byte_perm(x01, y01, 0x5410);
  w[1] = __byte_perm(x01, y01, 0x7632);
  w[2] = __byte_perm(x23, y23, 0x5410);
  w[3] = __byte_perm(x23, y23, 0x7632);
}

// The warp writes the packed words of columns 0 .. n-1 (n <= GC + 1) from
// ring rows p[0] (row r) and p[1] (row r - 1), each at its column 0, four
// words a lane at the columns whose output starts 16-byte aligned: each
// row's bytes c .. c + 4 from two funnel-shifted 32-bit loads, the words
// assembled by byte permutes and stored as one 16-byte vector (the up to
// three columns before them, and the tail, a word a lane).
template <int GC>
__device__ __forceinline__ void packed_row16(int* words,
                                             const uint8_t* const (&p)[2],
                                             int n, int lane) {
  const int nh = min(static_cast<int>(
                         (4 - (reinterpret_cast<uintptr_t>(words) >> 2)) & 3),
                     n);
  const int n4 = (n - nh) >> 2;
  if (lane < nh) at(words, lane) = ring_word<kPacked>(p, lane);
  const int xt = nh + 4 * n4 + lane;
  if (xt < n) at(words, xt) = ring_word<kPacked>(p, xt);
#pragma unroll
  for (int j = 0; j < ((GC + 4) / 4 + 31) / 32; ++j) {
    const int x = lane + 32 * j;
    if (x < n4) {
      const int c = nh + 4 * x;
      unsigned v[4], w[4];
      bytes4(p[0] - kOff16, kOff16 + c, v[0], v[1]);
      bytes4(p[1] - kOff16, kOff16 + c, v[2], v[3]);
      packed4(v, w);
      at(reinterpret_cast<int4*>(words + c), 0) = make_int4(
          static_cast<int>(w[0]), static_cast<int>(w[1]),
          static_cast<int>(w[2]), static_cast<int>(w[3]));
    }
  }
}

// The warp writes row r of a group (its column 0 is c0; columns 0 ..
// n-1, n <= GC + 1) for both tiles of the block, tile t from ring rt,
// where r <= last[t]: emit_row for a ring whose column 0 lies at byte
// kOff16.  Bytes go as 32-bit words funnel-shifted out of the ring's
// words, both tiles in one pass of fixed trip count (predicated); a
// word format a tile at a time: packed by packed_row16, packed6 and
// plane 2 a word a lane from the ring's bytes, plane 2's second word
// (rows r - 4 .. r - 6) beside the first (a fixed-trip pass over both
// tiles, 32-bit loads with byte permutes, and words assembled in the DP
// lanes' registers, all measured slower on the card).
template <class R, int FMT, int GC>
__device__ __forceinline__ void emit_rows16(const Args& a, int b0, int r,
                                            bool ok, const uint8_t* ring0,
                                            const uint8_t* ring1,
                                            const int (&rl)[2],
                                            const int (&qv)[2],
                                            const int (&last)[2], int lane,
                                            int c0, int n) {
  const size_t TJ = a.T + 1;
  const size_t off = (static_cast<size_t>(b0) * a.T + (r - 1)) * TJ + c0;
  const size_t tile = static_cast<size_t>(a.T) * TJ;
  const bool e0 = ok && r <= last[0], e1 = ok && r <= last[1];
  if constexpr (FMT == kBytes) {
    uint8_t* d = static_cast<uint8_t*>(a.dir) + off;
    copy_row_at<kOff16, GC + 1>(e0, d, ring_row16<R>(ring0, r, rl[0]), n,
                                qv[0] - c0, lane);
    copy_row_at<kOff16, GC + 1>(e1, d + tile, ring_row16<R>(ring1, r, rl[1]),
                                n, qv[1] - c0, lane);
  } else {
    constexpr int N = Lag<FMT>::value + 1;
    const uint8_t* const rings[2] = {ring0, ring1};
    const bool on[2] = {e0, e1};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint8_t* p[N];  // ring rows r .. r - lag, at their column 0
#pragma unroll
      for (int k = 0; k < N; ++k) {
        p[k] = ring_row16<R>(rings[t], r - k, rl[t]) + kOff16;
      }
      int* words = static_cast<int*>(a.dir) + off + t * tile;
      if (!on[t]) continue;
      if constexpr (FMT == kPacked) {
        packed_row16<GC>(words, p, n, lane);
      } else {
        for (int c = lane; c < n; c += 32) {
          at(words, c) = ring_word<FMT>(p, c);
          if constexpr (FMT == kPlane2) {
            at(a.dir2 + off + t * tile, c) =
                p[4][c - 2] | p[5][c - 2] << 5 | p[6][c - 3] << 10;
          }
        }
      }
    }
  }
}

// A boundary entry: warp w - 1's last column of row i for both tiles
// (M + go, D + ge, H of the row above, pairs) and its last four
// direction bytes of each tile.
struct __align__(16) Bnd16 {
  unsigned mgo, dge, hd, dlo, dhi, pad[3];
};

// Shared memory of a 16-bit split block: per tile the S * 32 / kGroup
// group rings; the ref rows as pairs (T + 32 of 4 bytes, 16-aligned);
// S + 1 boundary rings of kBnd entries (ring w is read by warp w; ring 0
// holds column 0's values, ring S is written by the last warp and never
// read); the max-cell reduction's [2][S] keys and corner scores.
template <int C, int FMT>
__host__ __device__ constexpr size_t split16_smem(int S, int T) {
  return 2 * static_cast<size_t>(S) * (32 / kGroup) *
             GroupRing16<C, FMT>::kBytes +
         round16(4 * (T + 32)) +
         static_cast<size_t>(S + 1) * kBnd * sizeof(Bnd16) +
         2 * static_cast<size_t>(S) * (sizeof(long long) + sizeof(int));
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

template <int C, int FMT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    align_tiles_split16(const Args a) {
  using R = GroupRing16<C, FMT>;
  constexpr int GW = 32 / kGroup;  // groups a warp
  constexpr int GC = kGroup * C;   // columns a group
  static_assert(C % 4 == 0, "four columns a 32-bit store");
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S = blockDim.x >> 5;
  const int sl = lane % kGroup;  // lane in its group
  const int b0 = 2 * blockIdx.x;
  const int T = a.T;
  const int jw = warp * 32 * C;  // columns left of this warp's strip
  const int jl = jw + lane * C;  // columns left of this lane's
  const size_t tile_rings = static_cast<size_t>(S) * GW * R::kBytes;
  uint32_t* sref = reinterpret_cast<uint32_t*>(smem + 2 * tile_rings);
  Bnd16* bnd = reinterpret_cast<Bnd16*>(smem + 2 * tile_rings +
                                        round16(4 * (T + 32)));
  long long* red_key = reinterpret_cast<long long*>(bnd + (S + 1) * kBnd);
  int* red_cor = reinterpret_cast<int*>(red_key + 2 * S);
  // Group q of this warp's ring for tile t (0 low, 1 high).
  auto ring = [&](int t, int q) {
    return smem + t * tile_rings + (warp * GW + q) * R::kBytes;
  };
  const Pair16 k = pair_scoring(a);

  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n16 = static_cast<int>(split16_smem<C, FMT>(S, T) / 16);
    for (int x = threadIdx.x; x < n16; x += blockDim.x) {
      z[x] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    // Column 0: M = 0, D = -inf, H = 0, zero direction bytes.
    for (int x = threadIdx.x; x < kBnd; x += blockDim.x) {
      bnd[x].mgo = k.go;
      bnd[x].dge = k.neg_ge;
    }
    const uint8_t* g0 = a.ref + static_cast<size_t>(b0) * T;
    const bool two = b0 + 1 < a.B;
    for (int x = threadIdx.x; x < T; x += blockDim.x) {
      sref[x] = at(g0, x) | (two ? static_cast<unsigned>(at(g0 + T, x)) << 16
                                 : 0u);
    }
    __syncthreads();
  }

  int rl[2], qv[2], last[2], crow[2], qloc[2];
  unsigned qp[C], klo[C], khi[C];
  int emax = 0;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int b = b0 + t;
    const bool live = b < a.B;  // B odd: the last block's second tile idles
    const int rlen = live ? at(a.ref_len, b) : 0;
    const int qlen = live ? at(a.query_len, b) : 0;
    rl[t] = max(0, min(rlen, T));
    qv[t] = max(0, min(qlen, T));
    last[t] = rl[t] > 0 ? min(rl[t] + Lag<FMT>::value, T) : 0;
    emax = max(emax, last[t]);
    const bool corner = rlen >= 1 && rlen <= T && qlen >= 1 && qlen <= T;
    crow[t] = corner ? rlen : -1;
    qloc[t] = qlen - 1 - jl;
  }
  const int nv0 = max(0, min(qv[0] - jl, C)), nv1 = max(0, min(qv[1] - jl, C));
  const uint8_t* g0 = a.query + static_cast<size_t>(b0) * T;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = jl + c;
    const unsigned lo = x < T ? at(g0, x) : 0u;
    const unsigned hi = x < T && b0 + 1 < a.B ? at(g0 + T, x) : 0u;
    qp[c] = lo | hi << 16;
    klo[c] = c < nv0 ? c : c | 0x80000000u;
    khi[c] = c < nv1 ? c : c | 0x80000000u;
  }

  unsigned mgo_up[C], ige_up[C], h_up[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    mgo_up[c] = k.go;
    ige_up[c] = k.neg_ge;
    h_up[c] = 0;
  }
  unsigned out_mgo = k.go, out_dge = k.neg_ge, out_hd = 0;
  int best_h[2] = {-1, -1}, best_i[2] = {0, 0}, best_c[2] = {0, 0};
  int corner_h[2] = {0, 0};

  const Bnd16* bin = bnd + warp * kBnd;   // this warp's boundary ring
  Bnd16* bout = bnd + (warp + 1) * kBnd;  // the next warp's
  const int steps = emax > 0 ? emax + 31 : 0;

  // Group q emits at step s the row it completed at step s - 1, r = s -
  // 16(q + 1), with its lag rows above it (the ring keeps 18 + lag rows,
  // RingOf's extra row: lane 15 hands row r + 17 on at step r + 32).
  // In the steady steps (every lane past row 0) the emission and the
  // row have no branch between them, so that the emission's loads and
  // stores issue among the row's arithmetic.
  auto emit = [&](int s) {
#pragma unroll
    for (int q = 0; q < GW; ++q) {
      const int r = s - kGroup * (q + 1);
      const int c0 = jw + q * GC;  // the group's column 0
      const bool tail = warp == S - 1 && q == GW - 1;
      const int n = tail ? T - c0 + 1 : min(GC, T - c0 + 1);
      emit_rows16<R, FMT, GC>(a, b0, r, r >= 1 && c0 <= T, ring(0, q),
                              ring(1, q), rl, qv, last, lane, c0, n);
    }
  };
  auto row = [&](int i, const Bnd16& e, unsigned mgo, unsigned dge,
                 unsigned diag) {
    const int bslot = i & (kBnd - 1);
    const int slot = static_cast<unsigned>(i - 1) % R::kRows;
    const size_t roff = slot * R::kRowBytes;
    uint8_t* glo = ring(0, lane / kGroup) + roff;
    uint8_t* ghi = ring(1, lane / kGroup) + roff;
    if (lane == 0) {  // columns -3 .. 0 of the warp's first group
      *reinterpret_cast<uint32_t*>(glo) = e.dlo;
      *reinterpret_cast<uint32_t*>(ghi) = e.dhi;
    }
    int key_lo, key_hi;
    unsigned dlo, dhi;
    row_cells16<C>(k, sref[i - 1], qp, klo, khi, mgo_up, ige_up, h_up,
                   reinterpret_cast<uint32_t*>(glo + 4 + sl * C),
                   reinterpret_cast<uint32_t*>(ghi + 4 + sl * C), mgo, dge,
                   diag, key_lo, key_hi, dlo, dhi);
    out_mgo = mgo;
    out_dge = dge;
    out_hd = diag;
    // A group's last lane hands its last four bytes on: within the warp
    // into the next group's ring, across warps with the boundary.
    if (lane == kGroup - 1) {
      *reinterpret_cast<uint32_t*>(ring(0, 1) + roff) = dlo;
      *reinterpret_cast<uint32_t*>(ring(1, 1) + roff) = dhi;
    }
    if (lane == 31) bout[bslot] = Bnd16{mgo, dge, diag, dlo, dhi, {}};
    const int key[2] = {key_lo, key_hi};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      // Rows come in order, so >= keeps the row-major-last maximum; a
      // row past rlen, or with no column up to qlen, does not count.
      bool later;
      best_h[t] = __vibmax_s32(i <= rl[t] && key[t] >= 0 ? key[t] >> 16 : -2,
                               best_h[t], &later);
      if (later) {
        best_i[t] = i;
        best_c[t] = key[t] & 0xffff;
      }
    }
    if (i == crow[0] || i == crow[1]) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        corner_h[0] |= i == crow[0] && c == qloc[0]
                           ? static_cast<int>(h_up[c] & 0xffffu) : 0;
        corner_h[1] |= i == crow[1] && c == qloc[1]
                           ? static_cast<int>(h_up[c] >> 16) : 0;
      }
    }
  };

  // One step more than the rows take: the last rows' emission.
  const int total = steps > 0 ? steps + 1 + (S - 1) * kLag : 0;
  for (int g = 1; g <= total; ++g) {
    const int s = g - warp * kLag;  // this warp's step
    if (s >= 1 && s <= steps + 1) {
      const int i = s - lane;  // this lane's row
      unsigned mgo = __shfl_up_sync(FULL, out_mgo, 1);
      unsigned dge = __shfl_up_sync(FULL, out_dge, 1);
      unsigned diag = __shfl_up_sync(FULL, out_hd, 1);
      const Bnd16 e = bin[i & (kBnd - 1)];
      if (lane == 0) {
        mgo = e.mgo;
        dge = e.dge;
        diag = e.hd;
      }
      if (s >= 32 && s <= steps) {  // every lane has a row
        emit(s);
        row(i, e, mgo, dge, diag);
      } else {
        emit(s);
        if (s <= steps && i >= 1) row(i, e, mgo, dge, diag);
      }
      __syncwarp();  // group q's rows are complete up to s + 1 - 16(q + 1)
      if constexpr (FMT != kBytes) {
        // The columns past qlen of the rows emitted next step, and the
        // handed-over ones, go to 0 before any word reads them.
#pragma unroll
        for (int q = 0; q < GW; ++q) {
          const int r = s + 1 - kGroup * (q + 1);
          const int c0 = jw + q * GC;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            if (r >= 1 && r <= rl[t] && c0 <= T) {
              uint8_t* rw = ring(t, q) + (r - 1) % R::kRows * R::kRowBytes +
                            kOff16;
              for (int x = max(qv[t] - c0 + 1, -3) + lane; x <= GC; x += 32) {
                rw[x] = 0;
              }
            }
          }
        }
        __syncwarp();
      }
    }
    if (g % kSync == 0) {
      if (warp > 0) {
        bar_sync(kFullBar + warp);
        bar_arrive(kEmptyBar + warp);
      }
      if (warp + 1 < S) {
        if (g > kSync) bar_sync(kEmptyBar + warp + 1);
        __threadfence_block();
        bar_arrive(kFullBar + warp + 1);
      }
    }
  }
  // The right neighbour's last kEmpty arrival.
  if (warp + 1 < S && total >= kSync) bar_sync(kEmptyBar + warp + 1);

  // The rows after last[t]: zero, each warp one S-th of them.
  const int TJ = T + 1;
  const size_t esize = FMT == kBytes ? 1 : 4;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (b0 + t >= a.B) continue;
    const size_t from =
        (static_cast<size_t>(b0 + t) * T + last[t]) * TJ * esize;
    const size_t n = static_cast<size_t>(T - last[t]) * TJ * esize;
    const size_t lo = n * warp / S, hi = n * (warp + 1) / S;
    zero_bytes(static_cast<uint8_t*>(a.dir) + from + lo, hi - lo, lane);
    if constexpr (FMT == kPlane2) {
      zero_bytes(reinterpret_cast<uint8_t*>(a.dir2) + from + lo, hi - lo,
                 lane);
    }
  }

  // Row-major-last max cell over the lanes, then over the warps.
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    long long key = best_h[t] >= 0
                        ? (static_cast<long long>(best_h[t]) << 32) |
                              (static_cast<long long>(best_i[t]) << 16) |
                              (jl + best_c[t] + 1)
                        : -1LL;
    int cor = corner_h[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      key = max(key, __shfl_xor_sync(FULL, key, o));
      cor = max(cor, __shfl_xor_sync(FULL, cor, o));
    }
    if (lane == 0) {
      red_key[t * S + warp] = key;
      red_cor[t * S + warp] = cor;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 && b0 + static_cast<int>(threadIdx.x) < a.B) {
    const int t = threadIdx.x;
    long long key = -1LL;
    int cor = 0;
    for (int w = 0; w < S; ++w) {
      key = max(key, red_key[t * S + w]);
      cor = max(cor, red_cor[t * S + w]);
    }
    const int b = b0 + t;
    const bool found = key >= 0;
    at(a.max_score, b) = found ? static_cast<int>(key >> 32) : 0;
    at(a.max_i, b) = found ? static_cast<int>((key >> 16) & 0xffff) : 0;
    at(a.max_j, b) = found ? static_cast<int>(key & 0xffff) : 0;
    at(a.pos_score, b) = cor;
  }
}

template <int C, int FMT>
int launch_split16(const Args& a, int strips, cudaStream_t stream) {
  if (strips < 1 || strips > kMaxWarps || 32 * C * strips < a.T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = split16_smem<C, FMT>(strips, a.T);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        align_tiles_split16<C, FMT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  align_tiles_split16<C, FMT>
      <<<(a.B + 1) / 2, 32 * strips, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The 16-bit split path at the strip width ops/dp.py picks: C = 16 in
// every format, and 24 in bytes (the widths its warps a tile take up to
// T = 2048; C = 8 and 12 ran slower there, C = 32 needs 255 registers
// and spills).
template <int FMT>
int by_width16(const Args& a, int strips, int width, cudaStream_t s) {
  if (width == 16) return launch_split16<16, FMT>(a, strips, s);
  if constexpr (FMT == kBytes) {
    if (width == 24) return launch_split16<24, FMT>(a, strips, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The 16-bit split path (ops/dp.py's gate): dtt_align_tiles's arguments;
// fmt 0 bytes (dir uint8), 1 packed, 2 packed6 (dir int32), 3 plane 2
// (dir and dir2 int32); interleave 1, 2 or 4 (B divides by it; the
// kernel is the same); strips 1..8 warps a block, each lane holding
// width columns (ops/dp.py picks both).
extern "C" int dtt_align_tiles16(const uint8_t* ref, const uint8_t* query,
                                 const int* ref_len, const int* query_len,
                                 int B, int T, int match, int mismatch,
                                 int gap_open, int gap_extend, int fmt,
                                 int interleave, int strips, int width,
                                 void* dir, int* dir2, int* max_score,
                                 int* max_i, int* max_j, int* pos_score,
                                 void* stream) {
  if (B <= 0 || T < 1 || (interleave != 1 && interleave != 2 &&
                          interleave != 4) || B % interleave != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{ref,      query,    ref_len,  query_len, B,
               T,        match,    mismatch, gap_open,  gap_extend,
               dir,      dir2,     max_score, max_i,    max_j,
               pos_score};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(s);
  switch (fmt) {
    case kBytes: return by_width16<kBytes>(a, strips, width, s);
    case kPacked: return by_width16<kPacked>(a, strips, width, s);
    case kPacked6: return by_width16<kPacked6>(a, strips, width, s);
    case kPlane2: return by_width16<kPlane2>(a, strips, width, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
