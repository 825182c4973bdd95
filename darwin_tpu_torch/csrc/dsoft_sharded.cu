// The table-sharded D-SOFT's per-shard steps, for Hopper (sm_90a).
//
// Replaces: darwin_tpu/dsoft/sharded_table.py, _dsoft_table_sharded_local
// (line 265), the per-device body of dsoft_table_sharded_fn under
// shard_map: plain XLA, not Pallas.  Its steps between the collectives
// (the occurrence sum, the num_seeds cap, the tuple expansion under the
// whole batch's budget and the hit exchange) stay PyTorch in
// darwin_tpu_torch/dsoft/sharded_table.py; the two steps that work a read
// at a time are these kernels.  Their plain PyTorch versions are
// sharded_table.py's shard_scan_torch and shard_count_torch.
//
// * shard_scan, one block a read (every read: the queries are replicated
//   on every shard): the minimizer scan of darwin_tpu's
//   _query_minimizers_fixed (the window minimum of the k-mer hashes over
//   positions lo = w-1 .. hi-1, hi = 16*ceil(qlen/16) - k - w, bytes at
//   and after qlen code 0; a change point where the minimum differs from
//   the previous position's, 0 before lo; emission at change points and
//   every w positions after the last one, the first run anchored at the
//   virtual p = 0), and each emitted minimizer's [start, end) in THIS
//   shard's table: a binary search of its sorted hashes (INDEX 0,
//   searchsorted left and right) or its DenseShardIndex (INDEX 1, the
//   two-level probe of twolevel_lookup).  Writes emit, start and occ =
//   end - start at every position of [R, LP], 0 where nothing is
//   emitted.  No num_seeds cap: that needs the occurrences summed over
//   the shards.
// * shard_count, one block a read this shard owns, over the tuples the
//   exchange brought it, grouped by read and in (offset, hit) order
//   within a read (one stable sort each in PyTorch): the read's keys
//   (bin ^ 2^31) << 32 | t, bin = (hit - offset) / bin_size on uint32, t
//   the tuple's index in the read, sorted (so by bin, offset, hit), the
//   per-bin counts as one segmented scan (k at a bin's first tuple,
//   min(k, offset delta) after it), each bin's first crossing of
//   threshold, and the first crossings in t order into the read's
//   [cand_max] rows of hits (uint32 bit patterns, -1 after them) and
//   offsets; counts = min(crossings, max_candidates, cand_max) and
//   over_c = min(crossings, max_candidates) > cand_max.
//
// What bounds them on the H100: bytes.  shard_scan writes nine bytes a
// position of every read and loads the index sectors its lookups touch;
// shard_count reads eight bytes a received tuple and writes the output
// rows.  Both are simple: shard_scan computes one position a thread (a
// chunk of 256 positions with three barriers), and shard_count sorts a
// read's keys by a bitonic network in shared memory (reads of up to
// kSmemTuples tuples) or, past it, in a scratch area of device memory
// the wrapper sizes, a barrier a stage.  Every global access goes through
// dtt::at.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

using dtt::at;

constexpr int NT = 256;  // threads a block, both kernels
constexpr int kMaxW = 16;  // w < k <= 15
constexpr int kMaxK = 15;
constexpr unsigned kFull = 0xFFFFFFFFu;
// shard_scan: positions a chunk (one a thread) and the codes staged for
// it (its k-mers' and its window minima's halo included).
constexpr int CH = NT;
constexpr int CHB = CH + kMaxW + kMaxK;
// shard_count: the tuples a read may have for its keys to stay in shared
// memory.
constexpr int kSmemTuples = 4096;

__host__ __device__ constexpr long long r16(long long n) {
  return (n + 15) & ~15ll;
}

// A read's keys and flags: in shared memory (G false) or in its scratch
// area in device memory (G true, accesses checked).
template <bool G, typename T>
__device__ __forceinline__ T& ra(T* p, ptrdiff_t i) {
  if constexpr (G) {
    return at(p, i);
  } else {
    return p[i];
  }
}

__device__ __forceinline__ uint8_t code_of(uint8_t b) {
  const uint32_t c = b | 0x20u;
  return c == 'c' ? 1 : c == 'g' ? 2 : c == 't' ? 3 : 0;
}

// Thomas Wang hash masked to 2k bits (ntcoding.cpp:74-85).
__device__ __forceinline__ uint32_t hash32(uint32_t key, uint32_t m) {
  key = (~key + (key << 21)) & m;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & m;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & m;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & m;
  return key;
}

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
// The segmented sum of (start flag << 32 | inc) pairs: a start resets the
// sum.  The low halves are sums over one bin's tuples of at most k each,
// under 2^31 since the wrapper takes only reads of n tuples with n * k <
// 2^31.
struct SegSum {
  __device__ unsigned long long operator()(unsigned long long a,
                                           unsigned long long b) const {
    return (b >> 32) ? b : a + b;
  }
};

// Block-wide exclusive scan of v (identity id) over NT threads; *total
// gets the block's reduction.  One barrier: sh (NT / 32 entries of 8
// bytes) must not be written again before another barrier.
template <typename T, typename Op>
__device__ T block_excl(T v, T id, Op op, long long* sh_raw, T* total) {
  T* sh = reinterpret_cast<T*>(sh_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = op(y, x);
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  T pre = id, tot = id;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    if (i < warp) pre = op(pre, sh[i]);
    tot = op(tot, sh[i]);
  }
  T ex = __shfl_up_sync(kFull, x, 1);
  ex = lane == 0 ? id : ex;
  *total = tot;
  return op(pre, ex);
}

// ---- shard_scan -------------------------------------------------------

struct ScanIndex {
  const uint32_t* h;  // sorted hashes (0) / distinct hashes hd (1)
  const int* crs;     // crs (1)
  const int* bkt;     // bucket directory (1)
  const int* base;
  const int* shift;
  int nh, nb, steps;
};

// (start, end) of hash hv in the shard's table.
template <int INDEX>
__device__ void lookup(const ScanIndex& ix, int base, int shift, uint32_t hv,
                       int* start, int* end) {
  if constexpr (INDEX == 0) {  // lower and upper bound, together
    int lo1 = 0, hi1 = ix.nh, lo2 = 0, hi2 = ix.nh;
    while (lo1 < hi1 || lo2 < hi2) {
      if (lo1 < hi1) {
        const int mid = (lo1 + hi1) >> 1;
        if (at(ix.h, mid) < hv) lo1 = mid + 1; else hi1 = mid;
      }
      if (lo2 < hi2) {
        const int mid = (lo2 + hi2) >> 1;
        if (at(ix.h, mid) <= hv) lo2 = mid + 1; else hi2 = mid;
      }
    }
    *start = lo1;
    *end = lo2;
  } else {  // darwin_tpu's twolevel_lookup over the shard's index
    const int rel = static_cast<int>(hv) - base;
    const int b = static_cast<int>(static_cast<unsigned>(max(rel, 0)) >>
                                   shift);
    const bool bvalid = rel >= 0 && b < ix.nb;
    const int bc = min(b, ix.nb - 1);
    int lo = at(ix.bkt, bc), hi = at(ix.bkt, bc + 1);
    for (int s = 0; s < ix.steps; ++s) {
      if (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (at(ix.h, min(max(mid, 0), ix.nh - 1)) < hv) lo = mid + 1;
        else hi = mid;
      }
    }
    const int d = min(lo, ix.nh - 1);
    const bool found = bvalid && lo < ix.nh && at(ix.h, d) == hv;
    *start = found ? at(ix.crs, d) : 0;
    *end = found ? at(ix.crs, d + 1) : 0;
  }
}

// One read a block, CH positions a chunk, one a thread: the codes of the
// chunk's k-mers staged, the hashes of positions cs - w .. cs + CH - 1
// computed once into shared memory, then each thread's window minima at
// p and p - 1, the run anchor by a block max scan, emission and lookup.
template <int INDEX>
__global__ void __launch_bounds__(NT)
    shard_scan(const uint8_t* queries, const int* qlens, int L, int LP,
               ScanIndex ix, int k, int w, uint8_t* emit, int* start,
               int* occ) {
  __shared__ uint8_t code[CHB];
  __shared__ uint32_t hh[CH + kMaxW];
  __shared__ long long sh[NT / 32];
  const int tid = threadIdx.x, r = blockIdx.x;
  const uint8_t* q = queries + static_cast<size_t>(r) * L;
  const int qlen = at(qlens, r);
  const int qend = min(max(qlen, 0), L);  // bytes past it code 0
  const int lo = w - 1;
  const int hi = min(16 * ((qlen + 15) / 16) - k - w, LP);
  const uint32_t hmask = (1u << (2 * k)) - 1u;
  const int ixbase = INDEX == 1 ? at(ix.base, 0) : 0;
  const int ixshift = INDEX == 1 ? at(ix.shift, 0) : 0;
  uint8_t* erow = emit + static_cast<size_t>(r) * LP;
  int* srow = start + static_cast<size_t>(r) * LP;
  int* orow = occ + static_cast<size_t>(r) * LP;
  int anchor = 0;  // the last change point before the chunk (virtual 0)
  for (int cs = 0; cs < LP; cs += CH) {
    const int p = cs + tid;
    const bool any = cs < hi && cs + CH > lo;  // block-uniform
    bool em = false;
    int st = 0, en = 0;
    if (any) {
      __syncthreads();  // the previous chunk's readers are done
      // code[j]: position cs - w + j.
      for (int j = tid; j < CH + w + k - 1; j += NT) {
        const int pos = cs - w + j;
        code[j] = pos >= 0 && pos < qend ? code_of(at(q, pos)) : 0;
      }
      __syncthreads();
      // hh[j]: the hash of the k-mer at position cs - w + j.
      for (int j = tid; j < CH + w; j += NT) {
        uint32_t seed = 0;
        for (int t = 0; t < k; ++t) {
          seed |= static_cast<uint32_t>(code[j + t]) << (2 * t);
        }
        hh[j] = hash32(seed, hmask);
      }
      __syncthreads();
      uint32_t m = 0xFFFFFFFFu, mp = 0xFFFFFFFFu;
      for (int s = 0; s < w; ++s) {
        m = min(m, hh[tid + w - s]);
        mp = min(mp, hh[tid + w - 1 - s]);
      }
      const bool inr = p >= lo && p < hi;
      const bool chg = inr && m != (p == lo ? 0u : mp);  // last_m = 0
      int last;
      int a = max(anchor, block_excl(chg ? p : -1, -1, Max(), sh, &last));
      anchor = max(anchor, last);
      if (chg) a = p;
      const int offset = p - a;
      em = inr && (chg || (offset % w == 0 && offset > 0));
      if (em) lookup<INDEX>(ix, ixbase, ixshift, m, &st, &en);
    }
    if (p < LP) {
      at(erow, p) = em;
      at(srow, p) = em ? st : 0;
      at(orow, p) = em ? en - st : 0;
    }
  }
}

// ---- shard_count ------------------------------------------------------

struct CountParams {
  const uint32_t* hit;  // the shard's tuples, by (read, offset, hit)
  const int* off;
  const long long* seg;  // [R + 1]: read r's tuples are seg[r] .. seg[r+1]
  int R, k, bin_size, threshold, max_candidates, cand_max;
  const long long* scratch_off;  // [R] byte offset of a read's scratch
  uint8_t* scratch;
  int* hits;
  int* offs;
  int* counts;
  uint8_t* over;
};

// The per-bin count at a sorted tuple from the segmented sum v up to it:
// the sum since the last start, or cum2 + 1 where no tuple up to here
// starts a segment (the plain version's seg_base of -1).
__device__ __forceinline__ int seg_count(unsigned long long v) {
  const int s = static_cast<int>(v & 0xFFFFFFFFull);
  return (v >> 32) ? s : s + 1;
}

// Read r's n tuples from s0: keys in keys (next_pow2(n) of them), first
// crossings flagged in fc by t, the output rows written.
template <bool G>
__device__ void count_read(const CountParams& P, int r, long long s0, int n,
                           unsigned long long* keys, uint8_t* fc,
                           long long (*sh)[NT / 32]) {
  const int tid = threadIdx.x;
  const uint32_t* hit = P.hit + s0;
  const int* off = P.off + s0;
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  for (int t = tid; t < p2; t += NT) {
    if (t < n) {
      const uint32_t d = at(hit, t) - static_cast<uint32_t>(at(off, t));
      const uint32_t bin = d / static_cast<uint32_t>(P.bin_size);
      ra<G>(keys, t) = static_cast<unsigned long long>(bin ^ 0x80000000u)
                           << 32 |
                       static_cast<uint32_t>(t);
      ra<G>(fc, t) = 0;
    } else {
      ra<G>(keys, t) = ~0ull;
    }
  }
  __syncthreads();
  // Bitonic sort of the p2 keys, ascending.
  for (int kk = 2; kk <= p2; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int c = tid; c < p2 / 2; c += NT) {
        const int i = 2 * c - (c & (j - 1));
        const unsigned long long x = ra<G>(keys, i);
        const unsigned long long y = ra<G>(keys, i + j);
        if ((x > y) == ((i & kk) == 0)) {
          ra<G>(keys, i) = y;
          ra<G>(keys, i + j) = x;
        }
      }
      __syncthreads();
    }
  }
  // The per-bin counts by one segmented scan over contiguous runs of the
  // sorted keys, and each bin's first crossing of threshold, flagged by t.
  const int E = (n + NT - 1) / NT;
  const int i0 = min(tid * E, n), i1 = min(i0 + E, n);
  int pbin = 0, poff = 0;  // the predecessor's bin and offset
  auto seg = [&](int i) -> unsigned long long {
    const unsigned long long key = ra<G>(keys, i);
    const int t = static_cast<int>(key & 0xFFFFFFFFull);
    const int bin = static_cast<int>(static_cast<uint32_t>(key >> 32) ^
                                     0x80000000u);
    const int o = at(off, t);
    const bool ss = i == 0 || bin != pbin;
    const int inc = ss ? P.k : min(o - poff, P.k);
    pbin = bin;
    poff = o;
    return static_cast<unsigned long long>(ss) << 32 |
           static_cast<uint32_t>(inc);
  };
  unsigned long long mine = 0;
  if (i0 > 0 && i0 < n) seg(i0 - 1);
  const int pbin0 = pbin, poff0 = poff;
  for (int i = i0; i < i1; ++i) mine = SegSum()(mine, seg(i));
  unsigned long long unused;
  unsigned long long cur = block_excl(mine, 0ull, SegSum(), sh[0], &unused);
  // The predecessor's crossing: cur is the scan up to it.
  bool prev_cross = i0 > 0 && i0 < n && seg_count(cur) >= P.threshold;
  pbin = pbin0;
  poff = poff0;
  for (int i = i0; i < i1; ++i) {
    const unsigned long long v = seg(i);
    cur = SegSum()(cur, v);
    const bool cross = seg_count(cur) >= P.threshold;
    if (cross && !(prev_cross && !(v >> 32))) {
      ra<G>(fc, static_cast<int>(ra<G>(keys, i) & 0xFFFFFFFFull)) = 1;
    }
    prev_cross = cross;
  }
  __syncthreads();
  // The first crossings in t order to the read's rows.
  int nf = 0;
  for (int t = i0; t < i1; ++t) nf += ra<G>(fc, t);
  int n_emit;
  int o = block_excl(nf, 0, Sum(), sh[1], &n_emit);
  const int nfin = min(min(n_emit, P.max_candidates), P.cand_max);
  int* hrow = P.hits + static_cast<size_t>(r) * P.cand_max;
  int* orow = P.offs + static_cast<size_t>(r) * P.cand_max;
  for (int t = i0; t < i1 && o < nfin; ++t) {
    if (ra<G>(fc, t)) {
      at(hrow, o) = static_cast<int>(at(hit, t));
      at(orow, o) = at(off, t);
      ++o;
    }
  }
  for (int c = nfin + tid; c < P.cand_max; c += NT) {
    at(hrow, c) = -1;
    at(orow, c) = -1;
  }
  if (tid == 0) {
    at(P.counts, r) = nfin;
    at(P.over, r) = min(n_emit, P.max_candidates) > P.cand_max;
  }
}

__global__ void __launch_bounds__(NT) shard_count(CountParams P) {
  __shared__ unsigned long long s_keys[kSmemTuples];
  __shared__ uint8_t s_fc[kSmemTuples];
  __shared__ long long sh[2][NT / 32];
  const int r = blockIdx.x;
  const long long s0 = at(P.seg, r);
  const int n = static_cast<int>(at(P.seg, r + 1) - s0);
  if (n <= kSmemTuples) {
    count_read<false>(P, r, s0, n, s_keys, s_fc, sh);
  } else {
    // The read's scratch: its keys (8 bytes a key of next_pow2(n)), then
    // its flags (n bytes), as shard_count's wrapper sizes it.
    uint8_t* base = P.scratch + at(P.scratch_off, r);
    long long p2 = 1;
    while (p2 < n) p2 <<= 1;
    count_read<true>(P, r, s0, n,
                     reinterpret_cast<unsigned long long*>(base),
                     base + 8 * p2, sh);
  }
}

}  // namespace

// shard_scan's index: 0 searchsorted (h = the shard's sorted hashes, nh of
// them), 1 dense (h = hd, crs, bkt, base, shift of the shard's
// DenseShardIndex, nh = its ND, nb its NB, steps its refine steps).
extern "C" int dtt_shard_scan(const uint8_t* queries, const int* qlens, int R,
                              int L, int LP, const uint32_t* h, const int* crs,
                              const int* bkt, const int* base,
                              const int* shift, int nh, int nb, int steps,
                              int k, int w, int index, uint8_t* emit,
                              int* start, int* occ, void* stream) {
  if (R < 0 || L < 0 || LP < L || k < 4 || k > kMaxK || w < 1 || w >= k ||
      nh < 1 || nb < 1 || steps < 0 || index < 0 || index > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0 || LP == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  const ScanIndex ix{h, crs, bkt, base, shift, nh, nb, steps};
  if (index == 0) {
    shard_scan<0><<<R, NT, 0, st>>>(queries, qlens, L, LP, ix, k, w, emit,
                                    start, occ);
  } else {
    shard_scan<1><<<R, NT, 0, st>>>(queries, qlens, L, LP, ix, k, w, emit,
                                    start, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tuples a read may hold for shard_count to keep its keys in shared
// memory; past it the read's keys and flags take r16(8 * next_pow2(n)) +
// r16(n) bytes of scratch at scratch_off[r].
extern "C" int dtt_shard_count_smem_tuples() { return kSmemTuples; }

extern "C" int dtt_shard_count(const uint32_t* hit, const int* off,
                               const long long* seg, int R, int k,
                               int bin_size, int threshold,
                               int max_candidates, int cand_max,
                               const long long* scratch_off,
                               uint8_t* scratch, int* hits, int* offs,
                               int* counts, uint8_t* over, void* stream) {
  if (R < 0 || k < 1 || bin_size < 1 || cand_max < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  const CountParams p{hit, off, seg, R, k, bin_size, threshold,
                      max_candidates, cand_max, scratch_off, scratch,
                      hits, offs, counts, over};
  shard_count<<<R, NT, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
