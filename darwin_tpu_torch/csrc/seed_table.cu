// Seed-table build for Hopper (sm_90a): the reference's w-window
// minimizers, emitted in scan order, then stably sorted by hash.
//
// Replaces: darwin_tpu/index/seed_table.py, SeedTable.build (line 42).
// The JAX package built its table on the host (the native library's
// threaded scan and radix sort, dtnative.cpp dt_build_table) and had no
// TPU kernel for it; these kernels take the host build off the path,
// with the card idle meanwhile (about 2.5 s a 48.5 Mbp job on the
// H100's host).  Wrapped by darwin_tpu_torch/index/table_device.py,
// whose plain versions repeat this arithmetic in PyTorch.
//
// What it computes, with dt_build_table's reference-genome convention:
// s_len = 1 + n/16 words, the scan over positions [w-1, 16*s_len-k-w),
// the bases past n read as zero codes, pack_words' 2-bit codes (ACGT in
// either case 0-3, every other byte 0), the seed at p its k codes from
// p (code i at bits 2i), hash32 of it masked to 2k bits, and m(p) the
// least hash of the w seeds ending at p.  The sequential emit rule (emit
// where m(p) differs from the last emitted minimum or w positions have
// passed since the last emission; last_m = last_p = 0 at the start)
// factors:
//   * a change at p: m(p) != m(p-1); at the first position m(p) != 0;
//   * the anchor of p: the last change at or before p;
//   * p emits where (p - anchor) % w == 0, or, before any change, where
//     p % w == 0 and p > 0 (the run of the virtual emission at 0).
// Positions >= n are dropped (the host build's filter).  The keys (hash,
// pos) then sort stably on the hash's 2k bits, so positions stay
// ascending within a hash: the order of the reference's sort of
// (hash << 32) | pos.
//
// What bounds it on the H100: for the scan its int32 operations (about
// 34 a position: hash32's 23, the seed's 4, the window minimum's w - 1,
// the tests' 4), just above its bytes (the bases once, 8 bytes a key):
// at 48.52 Mbp, k = 14, w = 4 (19.6 M keys) 0.099 ms against 0.061; for
// the sort its bytes, each key read and written once (0.094 ms).  What
// the kernels move: the bases twice (a count pass, then an emit pass),
// each key written once, and in each of the ceil(2k/8) sort passes the
// hashes for the histogram and every key read and written once, about
// 1.8 GB there (0.55 ms at 3.35 TB/s).  So each hash is computed once a
// pass from shared memory, and the minima are recomputed, not stored.
//
// Design:
//  * scan: blocks of 256 threads over tiles of 4096 positions.  A tile's
//    bases (from w before it to k - 1 past it) are packed into 2-bit
//    words in shared memory, each hash computed once into shared memory
//    and each window minimum from there, thread-interleaved (no bank
//    conflicts); then each thread walks 16 consecutive positions.  Runs
//    of one minimum cross tiles (homopolymers, the N padding between
//    pieces), so the anchor does too: seed_count writes each tile's
//    first and last change and its emissions from its first change on,
//    which need no anchor from before it; one block (seed_offsets) runs
//    over the tiles in order, giving each its incoming anchor (a running
//    max of last changes), its emissions before its first change
//    (counted arithmetically from that anchor) and its output offset (a
//    running sum); seed_emit redoes the tile's minima and writes its keys
//    at that offset in scan order.  The bases are read twice rather than
//    the minima stored: 49 MB a pass against 196 MB of minima.
//  * sort: least-significant-digit radix sort on 8-bit digits, three
//    kernels a pass over tiles of 4096 keys: a histogram a tile
//    (radix_hist), a running sum over the tiles of each digit
//    (radix_scan, a block a digit), and a stable scatter (radix_scatter):
//    each warp ranks its 512 keys in rounds of 32 with __match_any_sync
//    against counters of its own, the tile is ordered by digit in shared
//    memory and written out, a digit's keys to consecutive addresses.
//    Keys stay two uint32 arrays (hash, pos) from seed_emit on,
//    ping-ponging between two pairs; the last pass writes the table's.
// Every global access goes through dtt::at.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

using dtt::at;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;           // the tile kernels' block
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                // positions or keys a thread
constexpr int kTile = kThreads * kPer;  // 4096
constexpr int kMaxK = 15;
constexpr int kMaxW = kMaxK - 1;        // w < k
// A scan tile's 2-bit words: w positions before it to k - 1 past it,
// from a word boundary, and the word after the last.
constexpr int kTileWords = (kTile + kMaxW + kMaxK + 15) / 16 + 2;
// The minima of a tile, m(P0 - 1) .. m(P0 + kTile - 1), one slot padded
// in every 16 so that a thread's 16 consecutive ones share no bank with
// its neighbours'.
constexpr int kMinSlots = kTile + 1 + (kTile + 1) / 16 + 1;
constexpr int kRunThreads = 1024;  // seed_offsets, radix_scan: one block
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr long long kNone = -1;  // no change

static_assert(kThreads == kDigits, "radix_scatter: a thread a digit");

struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct Min {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};
struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};

// Inclusive scan of v over the block under op (identity id); *excl gets
// the exclusive value, *total the block's.  s holds blockDim.x / 32
// values.  Every thread of the block calls it; it ends in a barrier.
template <typename T, typename Op>
__device__ T block_scan(T v, T* s, T id, Op op, T* excl, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = op(u, v);
  }
  T before = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) before = id;
  if (lane == 31) s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T t = lane < nw ? s[lane] : id;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T u = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t = op(u, t);
    }
    if (lane < nw) s[lane] = t;
  }
  __syncthreads();
  if (warp > 0) {
    v = op(s[warp - 1], v);
    before = op(s[warp - 1], before);
  }
  *excl = before;
  *total = s[nw - 1];
  __syncthreads();
  return v;
}

// ------------------------------------------------------------- the scan

struct Scan {
  long long n;       // bases
  long long lo, hi;  // scanned positions [lo, hi)
  int k, w;
  uint32_t mask;     // 2k bits
};

__device__ __forceinline__ uint32_t twobit(uint8_t c) {
  switch (c) {
    case 'c': case 'C': return 1;
    case 'g': case 'G': return 2;
    case 't': case 'T': return 3;
    default: return 0;
  }
}

// Thomas Wang's 32-bit hash masked to 2k bits (dtnative.cpp hash32).
__device__ __forceinline__ uint32_t hash32(uint32_t key, uint32_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

__device__ __forceinline__ int pad(int u) { return u + (u >> 4); }

// Shared memory of a scan tile.
struct TileSmem {
  uint32_t words[kTileWords];
  uint32_t hash[kTile + kMaxW];
  uint32_t m[kMinSlots];
  long long s[kWarps];
};

// Fills t.m: m[pad(u)] is the window minimum at position P0 - 1 + u, u
// in [0, kTile].  Ends in a barrier.
__device__ void tile_minima(const uint8_t* bases, const Scan& g,
                            long long P0, TileSmem& t) {
  // Hashes at positions Q0 + i, i in [0, kTile + w); Q0 >= -1.
  const long long Q0 = P0 - g.w;
  const long long W0 = Q0 >= 0 ? (Q0 & ~15LL) : -16;
  for (int j = threadIdx.x; j < kTileWords; j += kThreads) {
    const long long q0 = W0 + 16LL * j;
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const long long q = q0 + b;
      if (q >= 0 && q < g.n) word |= twobit(at(bases, q)) << (2 * b);
    }
    t.words[j] = word;
  }
  __syncthreads();
  const int off = static_cast<int>(Q0 - W0);
  for (int i = threadIdx.x; i < kTile + g.w; i += kThreads) {
    const int r = off + i;
    const unsigned long long two =
        (static_cast<unsigned long long>(t.words[(r >> 4) + 1]) << 32) |
        t.words[r >> 4];
    t.hash[i] = hash32(static_cast<uint32_t>(two >> (2 * (r & 15))) &
                           g.mask, g.mask);
  }
  __syncthreads();
  for (int u = threadIdx.x; u <= kTile; u += kThreads) {
    uint32_t v = t.hash[u];
    for (int d = 1; d < g.w; ++d) v = min(v, t.hash[u + d]);
    t.m[pad(u)] = v;
  }
  __syncthreads();
}

// The changes among this thread's 16 positions P0 + 16 tid + i, bit i.
__device__ __forceinline__ uint32_t change_bits(const Scan& g, long long P0,
                                                const uint32_t* m) {
  const int u0 = kPer * threadIdx.x;
  uint32_t bits = 0;
  uint32_t prev = m[pad(u0)];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long p = P0 + u0 + i;
    const uint32_t cur = m[pad(u0 + i + 1)];
    if (p < g.hi && (p == g.lo ? cur != 0 : cur != prev)) bits |= 1u << i;
    prev = cur;
  }
  return bits;
}

// Walks this thread's positions from base, calling f(i, p, anchored) at
// each that emits; anchored says whether a change came before it (else
// it counts from the virtual anchor at 0).  ph is (base - anchor) % w.
template <typename F>
__device__ __forceinline__ void walk(const Scan& g, long long base,
                                     uint32_t bits, bool anchored, int ph,
                                     F f) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long p = base + i;
    if (p >= g.hi) break;
    if ((bits >> i) & 1u) {
      ph = 0;
      anchored = true;
    }
    if (ph == 0 && p < g.n && (anchored || p > 0)) f(i, p, anchored);
    ph = ph + 1 == g.w ? 0 : ph + 1;
  }
}

// A tile's first change (kNone if none), last change (kNone if none) and
// its emissions from its first change on.
__global__ void __launch_bounds__(kThreads)
    seed_count(const uint8_t* bases, Scan g, long long* first,
               long long* last, long long* count) {
  __shared__ TileSmem t;
  const long long P0 = g.lo + static_cast<long long>(blockIdx.x) * kTile;
  tile_minima(bases, g, P0, t);
  const uint32_t bits = change_bits(g, P0, t.m);
  const long long base = P0 + kPer * threadIdx.x;
  const long long lc = bits ? base + 31 - __clz(bits) : kNone;
  const long long fc = bits ? base + __ffs(bits) - 1 : LLONG_MAX;
  long long before, last_c, unused, first_c;
  block_scan(lc, t.s, kNone, Max(), &before, &last_c);
  block_scan(fc, t.s, LLONG_MAX, Min(), &unused, &first_c);
  long long c = 0;
  const bool anchored = before != kNone;
  walk(g, base, bits, anchored,
       anchored ? static_cast<int>((base - before) % g.w) : 0,
       [&](int, long long, bool a) { c += a; });
  long long c_before, c_total;
  block_scan(c, t.s, 0LL, Sum(), &c_before, &c_total);
  if (threadIdx.x == 0) {
    at(first, blockIdx.x) = first_c == LLONG_MAX ? kNone : first_c;
    at(last, blockIdx.x) = last_c;
    at(count, blockIdx.x) = c_total;
  }
}

// The emissions in [s, e) before a tile's first change, from anchor a
// (kNone: the virtual anchor at 0, which does not emit at 0 itself).
__device__ long long congruent(long long s, long long e, long long a,
                               int w) {
  if (a == kNone) {
    a = 0;
    s = s > 1 ? s : 1;
  }
  if (e <= s) return 0;
  const long long first = s + ((a - s) % w + w) % w;
  return first < e ? (e - 1 - first) / w + 1 : 0;
}

// One block over the tiles in order: each tile's incoming anchor and its
// output offset; *total the number of keys.
__global__ void __launch_bounds__(kRunThreads)
    seed_offsets(Scan g, long long tiles, const long long* first,
                 const long long* last, const long long* count,
                 long long* anchor, long long* offset, long long* total) {
  __shared__ long long s[kRunThreads / 32];
  long long carry_a = kNone, carry_n = 0;
  for (long long t0 = 0; t0 < tiles; t0 += kRunThreads) {
    const long long t = t0 + threadIdx.x;
    const bool ok = t < tiles;
    long long before, all;
    block_scan(ok ? at(last, t) : kNone, s, kNone, Max(), &before, &all);
    const long long a = carry_a > before ? carry_a : before;
    long long c = 0;
    if (ok) {
      const long long P0 = g.lo + t * kTile;
      const long long fc = at(first, t);
      long long end = fc != kNone ? fc
                      : (P0 + kTile < g.hi ? P0 + kTile : g.hi);
      end = end < g.n ? end : g.n;
      c = at(count, t) + congruent(P0, end, a, g.w);
    }
    long long c_before, c_all;
    block_scan(c, s, 0LL, Sum(), &c_before, &c_all);
    if (ok) {
      at(anchor, t) = a;
      at(offset, t) = carry_n + c_before;
    }
    carry_a = carry_a > all ? carry_a : all;
    carry_n += c_all;
  }
  if (threadIdx.x == 0) at(total, 0) = carry_n;
}

// A tile's keys at its offset, in scan order.
__global__ void __launch_bounds__(kThreads)
    seed_emit(const uint8_t* bases, Scan g, const long long* anchor,
              const long long* offset, uint32_t* out_hash,
              uint32_t* out_pos) {
  __shared__ TileSmem t;
  const long long P0 = g.lo + static_cast<long long>(blockIdx.x) * kTile;
  tile_minima(bases, g, P0, t);
  const uint32_t bits = change_bits(g, P0, t.m);
  const long long base = P0 + kPer * threadIdx.x;
  const long long lc = bits ? base + 31 - __clz(bits) : kNone;
  long long before, unused;
  block_scan(lc, t.s, kNone, Max(), &before, &unused);
  const long long in = at(anchor, blockIdx.x);
  const long long a = in > before ? in : before;
  const bool anchored = a != kNone;
  const int ph = static_cast<int>((base - (anchored ? a : 0)) % g.w);
  long long c = 0;
  walk(g, base, bits, anchored, ph, [&](int, long long, bool) { ++c; });
  long long c_before, c_total;
  block_scan(c, t.s, 0LL, Sum(), &c_before, &c_total);
  long long o = at(offset, blockIdx.x) + c_before;
  const int u0 = kPer * threadIdx.x;
  walk(g, base, bits, anchored, ph, [&](int i, long long p, bool) {
    at(out_hash, o) = t.m[pad(u0 + i + 1)];
    at(out_pos, o) = static_cast<uint32_t>(p);
    ++o;
  });
}

// ------------------------------------------------------------- the sort

// counts[d * tiles + tile]: the keys of each tile whose digit is d.
__global__ void __launch_bounds__(kThreads)
    radix_hist(const uint32_t* hash, long long n, int shift,
               uint32_t* counts, long long tiles) {
  __shared__ uint32_t h[kDigits];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long j = base + i;
    if (j < n) atomicAdd(&h[(at(hash, j) >> shift) & (kDigits - 1)], 1u);
  }
  __syncthreads();
  at(counts, threadIdx.x * tiles + blockIdx.x) = h[threadIdx.x];
}

// A block a digit: its row of counts becomes the keys of that digit in
// the tiles before each; totals[d] the digit's keys.
__global__ void __launch_bounds__(kRunThreads)
    radix_scan(uint32_t* counts, long long tiles, uint32_t* totals) {
  __shared__ uint32_t s[kRunThreads / 32];
  uint32_t* row = counts + blockIdx.x * tiles;
  uint32_t carry = 0;
  for (long long t0 = 0; t0 < tiles; t0 += kRunThreads) {
    const long long t = t0 + threadIdx.x;
    const uint32_t v = t < tiles ? at(row, t) : 0u;
    uint32_t before, all;
    block_scan(v, s, 0u, Sum(), &before, &all);
    if (t < tiles) at(row, t) = carry + before;
    carry += all;
  }
  if (threadIdx.x == 0) at(totals, blockIdx.x) = carry;
}

// A tile's keys to their places in the pass's order, stably.
__global__ void __launch_bounds__(kThreads)
    radix_scatter(const uint32_t* in_hash, const uint32_t* in_pos,
                  long long n, int shift, const uint32_t* counts,
                  const uint32_t* totals, long long tiles,
                  uint32_t* out_hash, uint32_t* out_pos) {
  __shared__ uint32_t s_hash[kTile];
  __shared__ uint32_t s_pos[kTile];
  __shared__ uint32_t cnt[kWarps][kDigits];
  __shared__ uint32_t start[kDigits];
  __shared__ long long gofs[kDigits];
  __shared__ long long s64[kWarps];
  __shared__ uint32_t s32[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int len = static_cast<int>(n - base < kTile ? n - base : kTile);
  for (int i = threadIdx.x; i < kWarps * kDigits; i += kThreads) {
    cnt[i / kDigits][i % kDigits] = 0;
  }
  __syncthreads();
  // Warp w ranks keys [512 w, 512 w + 512) of the tile, 32 a round: a
  // key's rank is the keys of its digit before it in the warp's rounds.
  uint32_t h[kPer], p[kPer], rank[kPer];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = warp * kPer * 32 + r * 32 + lane;
    const bool ok = i < len;
    h[r] = ok ? at(in_hash, base + i) : 0u;
    p[r] = ok ? at(in_pos, base + i) : 0u;
    const uint32_t d = ok ? (h[r] >> shift) & (kDigits - 1) : kDigits;
    const unsigned peers = __match_any_sync(kFull, d);
    const uint32_t seen = ok ? cnt[warp][d] : 0u;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) cnt[warp][d] = seen + __popc(peers);
    __syncwarp();
    rank[r] = seen + __popc(peers & below);
  }
  __syncthreads();
  // Thread d: digit d's keys in the warps before each, where the digit
  // starts in the tile's order, and where in the output.
  const int d = threadIdx.x;
  uint32_t run = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = cnt[w][d];
    cnt[w][d] = run;
    run += c;
  }
  uint32_t in_tile, tile_len;
  block_scan(run, s32, 0u, Sum(), &in_tile, &tile_len);
  long long digit_base, all;
  block_scan(static_cast<long long>(at(totals, d)), s64, 0LL, Sum(),
             &digit_base, &all);
  start[d] = in_tile;
  gofs[d] = digit_base + at(counts, d * tiles + blockIdx.x) - in_tile;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = warp * kPer * 32 + r * 32 + lane;
    if (i < len) {
      const uint32_t dd = (h[r] >> shift) & (kDigits - 1);
      const int li = start[dd] + cnt[warp][dd] + rank[r];
      s_hash[li] = h[r];
      s_pos[li] = p[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const uint32_t hv = s_hash[i];
    const long long o = gofs[(hv >> shift) & (kDigits - 1)] + i;
    at(out_hash, o) = hv;
    at(out_pos, o) = s_pos[i];
  }
}

Scan scan_of(long long n, int k, int w) {
  Scan g;
  g.n = n;
  g.k = k;
  g.w = w;
  g.lo = w - 1;
  g.hi = 16 * (1 + n / 16) - k - w;
  g.mask = static_cast<uint32_t>((1ull << (2 * k)) - 1);
  return g;
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// 3 < k <= 15, 1 <= w < k, positions below 2^32 and some to scan.
bool valid_scan(long long n, int k, int w) {
  return 3 < k && k <= kMaxK && 1 <= w && w < k && n >= 0 &&
         n < (1LL << 32) - 16 && 16 * (1 + n / 16) - k - w > w - 1;
}

}  // namespace

// The count: with T = ceil((hi - lo) / 4096) scan tiles, meta is 5 T + 1
// int64: each tile's first change, last change and count (seed_count),
// then its anchor and offset (seed_offsets), then the number of keys.
// Needs hi > lo and n < 2^32 - 16 (positions are uint32).
extern "C" int dtt_seed_count(const uint8_t* bases, long long n, int k,
                              int w, long long* meta, void* stream) {
  if (!valid_scan(n, k, w)) return static_cast<int>(cudaErrorInvalidValue);
  const Scan g = scan_of(n, k, w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(s);
  const long long T = tiles_of(g.hi - g.lo);
  seed_count<<<static_cast<unsigned>(T), kThreads, 0, s>>>(
      bases, g, meta, meta + T, meta + 2 * T);
  seed_offsets<<<1, kRunThreads, 0, s>>>(g, T, meta, meta + T, meta + 2 * T,
                                         meta + 3 * T, meta + 4 * T,
                                         meta + 5 * T);
  return static_cast<int>(cudaGetLastError());
}

// The keys, meta[5 T] of them, into out_hash and out_pos in scan order.
extern "C" int dtt_seed_emit(const uint8_t* bases, long long n, int k, int w,
                             const long long* meta, uint32_t* out_hash,
                             uint32_t* out_pos, void* stream) {
  if (!valid_scan(n, k, w)) return static_cast<int>(cudaErrorInvalidValue);
  const Scan g = scan_of(n, k, w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(s);
  const long long T = tiles_of(g.hi - g.lo);
  seed_emit<<<static_cast<unsigned>(T), kThreads, 0, s>>>(
      bases, g, meta + 3 * T, meta + 4 * T, out_hash, out_pos);
  return static_cast<int>(cudaGetLastError());
}

// Sorts n keys by the low `bits` bits of their hash, stably: ceil(bits/8)
// passes from (hash, pos) to (hash2, pos2) and back, so the result is in
// the second pair after an odd number of passes and in the first after
// an even one.  scratch: 256 (T + 1) uint32, T = ceil(n / 4096).
extern "C" int dtt_radix_sort(uint32_t* hash, uint32_t* pos, uint32_t* hash2,
                              uint32_t* pos2, long long n, int bits,
                              uint32_t* scratch, void* stream) {
  if (n < 1 || n >= (1LL << 32) || bits < 1 || bits > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(s);
  const long long T = tiles_of(n);
  uint32_t* counts = scratch;
  uint32_t* totals = scratch + kDigits * T;
  uint32_t* src[2] = {hash, pos};
  uint32_t* dst[2] = {hash2, pos2};
  for (int shift = 0; shift < bits; shift += kDigitBits) {
    const unsigned grid = static_cast<unsigned>(T);
    radix_hist<<<grid, kThreads, 0, s>>>(src[0], n, shift, counts, T);
    radix_scan<<<kDigits, kRunThreads, 0, s>>>(counts, T, totals);
    radix_scatter<<<grid, kThreads, 0, s>>>(src[0], src[1], n, shift, counts,
                                            totals, T, dst[0], dst[1]);
    for (int i = 0; i < 2; ++i) {
      uint32_t* x = src[i];
      src[i] = dst[i];
      dst[i] = x;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
