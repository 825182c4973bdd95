// The parts of D-SOFT that the device D-SOFT (dsoft.cu) and the
// table-sharded D-SOFT's per-read steps (dsoft_sharded.cu) share: the
// minimizer scan's pieces (a chunk's codes staged through registers, the
// lookups of a thread's positions issued together) and the count's (the
// (bin, t) keys sorted in registers and shuffles or, for a longer read,
// in memory, the per-bin counts and first crossings by one segmented
// scan, their compaction in t order).  Each translation unit takes its
// own copy (an anonymous namespace).  Every global access goes through
// dtt::at.

#pragma once

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

using dtt::at;

constexpr int kMaxW = 16;    // w < k <= 15
constexpr int kMaxK = 15;
constexpr unsigned kFull = 0xFFFFFFFFu;
// Positions a chunk of the minimizer scan, and the bytes of a chunk
// staged (its k-mers' and its window minima's halo included).
constexpr int CH = 1024;
constexpr int CHB = CH + kMaxW + kMaxK;

__host__ __device__ constexpr long long r16(long long n) {
  return (n + 15) & ~15ll;
}

// An array of a read: in shared memory (G false) or in device memory (G
// true, accesses checked).
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
// The segmented sum of (start flag << 32 | inc) pairs: a start resets
// the sum.  The low halves are sums over one bin's tuples of at most k
// each, under 2^31 since the entries take only n * k < 2^31 tuples: a +
// b carries nothing into the flag and seg_count's int holds them.
struct SegSum {
  __device__ unsigned long long operator()(unsigned long long a,
                                           unsigned long long b) const {
    return (b >> 32) ? b : a + b;
  }
};

// Block-wide exclusive scan of v (identity id) over NTH threads; *total
// gets the block's reduction.  One barrier: sh (NTH / 32 entries of 8
// bytes) must not be written again before another barrier, so callers
// alternate two buffers.
template <int NTH, typename T, typename Op>
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
  for (int i = 0; i < NTH / 32; ++i) {
    if (i < warp) pre = op(pre, sh[i]);
    tot = op(tot, sh[i]);
  }
  T ex = __shfl_up_sync(kFull, x, 1);
  ex = lane == 0 ? id : ex;
  *total = tot;
  return op(pre, ex);
}

// ---- the minimizer scan -------------------------------------------------

// A seed table's index: INDEX 0 a binary search of the sorted hashes h
// (nh of them), 1 a dense CSR over the 4^k hashes (csr), 2 darwin_tpu's
// two-level index (h = the distinct hashes, csr = their CSR starts, bkt
// = the bucket directory of nb buckets, base and shift, steps refine
// steps), 3 the same index and result with each bucket's hashes loaded
// in one round.  dsoft.cu takes 2 and shard_scan 3, each the faster on
// that kernel (PERF.md §6).
struct Index {
  const uint32_t* h;
  const int* csr;
  const int* bkt;
  const int* base;
  const int* shift;
  int nh, nb, steps;
};

// (start, end) of the hashes hv[e] with act[e] set, (0, 0) for the
// others; the PP lookups advance together, each step of their chains
// one round of independent loads.
template <int INDEX, int PP>
__device__ void lookup_multi(const Index& ix, int base, int shift,
                             const uint32_t (&hv)[PP], const bool (&act)[PP],
                             int (&start)[PP], int (&end)[PP]) {
  if constexpr (INDEX == 0) {  // lower and upper bound of hv, together
    int lo1[PP], hi1[PP], lo2[PP], hi2[PP];
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      lo1[e] = lo2[e] = 0;
      hi1[e] = hi2[e] = act[e] ? ix.nh : 0;
    }
    bool busy = true;
    while (busy) {
      uint32_t v1[PP], v2[PP];
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        v1[e] = lo1[e] < hi1[e] ? at(ix.h, (lo1[e] + hi1[e]) >> 1) : 0u;
        v2[e] = lo2[e] < hi2[e] ? at(ix.h, (lo2[e] + hi2[e]) >> 1) : 0u;
      }
      busy = false;
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        if (lo1[e] < hi1[e]) {
          const int mid = (lo1[e] + hi1[e]) >> 1;
          if (v1[e] < hv[e]) lo1[e] = mid + 1; else hi1[e] = mid;
        }
        if (lo2[e] < hi2[e]) {
          const int mid = (lo2[e] + hi2[e]) >> 1;
          if (v2[e] <= hv[e]) lo2[e] = mid + 1; else hi2[e] = mid;
        }
        busy |= lo1[e] < hi1[e] || lo2[e] < hi2[e];
      }
    }
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      start[e] = act[e] ? lo1[e] : 0;
      end[e] = act[e] ? lo2[e] : 0;
    }
  } else if constexpr (INDEX == 1) {
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      const int h = min(static_cast<int>(hv[e]), ix.nh - 1);
      start[e] = act[e] ? at(ix.csr, h) : 0;
      end[e] = act[e] ? at(ix.csr, h + 1) : 0;
    }
  } else if constexpr (INDEX == 2) {  // darwin_tpu's twolevel_lookup
    int lo[PP], hi[PP];
    bool bvalid[PP];
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      const int rel = static_cast<int>(hv[e]) - base;
      const int b = static_cast<int>(static_cast<unsigned>(max(rel, 0)) >>
                                     shift);
      bvalid[e] = rel >= 0 && b < ix.nb;
      const int bc = min(b, ix.nb - 1);
      lo[e] = act[e] ? at(ix.bkt, bc) : 0;
      hi[e] = act[e] ? at(ix.bkt, bc + 1) : 0;
    }
    for (int s = 0; s < ix.steps; ++s) {
      uint32_t v[PP];
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        const int mid = (lo[e] + hi[e]) >> 1;
        v[e] = lo[e] < hi[e] ? at(ix.h, min(max(mid, 0), ix.nh - 1)) : 0u;
      }
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        if (lo[e] < hi[e]) {
          const int mid = (lo[e] + hi[e]) >> 1;
          if (v[e] < hv[e]) lo[e] = mid + 1; else hi[e] = mid;
        }
      }
    }
    // The verify load and the CSR pair in one round.
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      const int d = min(lo[e], ix.nh - 1);
      uint32_t hd = 0;
      int c0 = 0, c1 = 0;
      if (act[e]) {
        hd = at(ix.h, d);
        c0 = at(ix.csr, d);
        c1 = at(ix.csr, d + 1);
      }
      const bool found = act[e] && bvalid[e] && lo[e] < ix.nh && hd == hv[e];
      start[e] = found ? c0 : 0;
      end[e] = found ? c1 : 0;
    }
  } else {  // INDEX 3
    // Three rounds of loads: the bucket's bounds, its hashes (all at
    // once: independent loads), the CSR pair.  A bucket holds the
    // distinct hashes of its bucket id only, so where it holds fewer than
    // 2^steps of them (the steps refine steps then end at its lower bound
    // of hv) that bound is lo plus the bucket's hashes below hv, and hv
    // is in the index iff it is in its bucket.  A thread with a wider
    // bucket (a caller that passes fewer steps than the index was built
    // with) takes INDEX 2.  A hash outside the directory's range is
    // absent, unloaded.
    int lo[PP], hi[PP], lb[PP];
    bool found[PP];
    int wmax = 0;
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      const int rel = static_cast<int>(hv[e]) - base;
      const int b = static_cast<int>(static_cast<unsigned>(max(rel, 0)) >>
                                     shift);
      const bool go = act[e] && rel >= 0 && b < ix.nb;
      lo[e] = go ? at(ix.bkt, b) : 0;
      hi[e] = go ? at(ix.bkt, b + 1) : 0;
      lb[e] = lo[e];
      found[e] = false;
      wmax = max(wmax, hi[e] - lo[e]);
    }
    if (ix.steps < 31 && wmax >= (1 << ix.steps)) {
      lookup_multi<2, PP>(ix, base, shift, hv, act, start, end);
      return;
    }
#pragma unroll 4
    for (int i = 0; i < wmax; ++i) {
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        if (lo[e] + i < hi[e]) {
          const uint32_t v = at(ix.h, lo[e] + i);
          lb[e] += v < hv[e];
          found[e] |= v == hv[e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      start[e] = found[e] ? at(ix.csr, lb[e]) : 0;
      end[e] = found[e] ? at(ix.csr, lb[e] + 1) : 0;
    }
  }
}

// The NL bytes a thread loads of a staged chunk whose index 0 is position
// base (code 0 outside [0, qend)).
template <int NTH, int NL>
__device__ __forceinline__ void load_chunk(const uint8_t* q, int qend,
                                           int base, int win,
                                           uint8_t (&b)[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int i = threadIdx.x + j * NTH;
    const int p = base + i;
    b[j] = i < win && p >= 0 && p < qend ? at(q, p) : 0;
  }
}

template <int NTH, int NL>
__device__ __forceinline__ void stage_chunk(uint8_t* dst,
                                            const uint8_t (&b)[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int i = threadIdx.x + j * NTH;
    if (i < CHB) dst[i] = code_of(b[j]);
  }
}

// ---- the count ----------------------------------------------------------

// The sorted tuple at i: its t, bin, offset and validity.
struct Tuple {
  int t, bin, off;
  bool valid;
};

// keys and flags in shared (G false) or device memory (G true); hit and
// offset by t likewise (GT).
template <bool G, bool GT>
__device__ __forceinline__ Tuple tuple_at(const unsigned long long* keys,
                                          const uint32_t* hitv,
                                          const int* toffv, int i) {
  const unsigned long long key = ra<G>(keys, i);
  Tuple u;
  u.t = static_cast<int>(key & 0xFFFFFFFFull);
  u.bin = static_cast<int>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
  u.off = ra<GT>(toffv, u.t);
  u.valid = ra<GT>(hitv, u.t) >= static_cast<uint32_t>(u.off);
  return u;
}

// The sort key of tuple t with this hit and offset: (bin ^ 2^31) << 32
// | t, bin the uint32 quotient (hit - offset) / bin_size taken as int32,
// INT32_MAX where the tuple is not valid (hit < offset).
__device__ __forceinline__ unsigned long long tuple_key(uint32_t hit,
                                                        int toff, int t,
                                                        int bin_size) {
  const bool valid = hit >= static_cast<uint32_t>(toff);
  const int bin = valid ? static_cast<int>((hit - static_cast<uint32_t>(toff))
                                           / static_cast<uint32_t>(bin_size))
                        : INT_MAX;
  return static_cast<unsigned long long>(static_cast<uint32_t>(bin) ^
                                         0x80000000u) << 32 |
         static_cast<uint32_t>(t);
}

// Ascending bitonic sort of the first p2 (a power of two) of NTH * E
// keys (64- or 32-bit K), thread t holding keys t*E .. t*E+E-1 in x; the
// keys past p2 are ~0 and stay so.  Strides below E run in registers,
// below 32 * E by shuffles, the rest through sk (NTH * E keys of shared
// memory), a barrier a stage.  A thread's last reads of sk are its own
// keys' slots.
template <int NTH, int E, typename K>
__device__ void sort_keys(K (&x)[E], int p2, K* sk) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int kk = 2; kk <= p2; kk <<= 1) {
    int j = kk >> 1;
    if (j >= 32 * E) {
      __syncthreads();  // earlier readers of sk are done
#pragma unroll
      for (int e = 0; e < E; ++e) sk[tid * E + e] = x[e];
      __syncthreads();
      for (; j >= 32 * E; j >>= 1) {
        for (int c = tid; c < p2 / 2; c += NTH) {
          const int i = 2 * c - (c & (j - 1));
          const K a = sk[i], b = sk[i + j];
          if ((a > b) == ((i & kk) == 0)) {
            sk[i] = b;
            sk[i + j] = a;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = sk[tid * E + e];
    }
    for (; j >= E; j >>= 1) {
      const int d = j / E;
      const bool lower = (lane & d) == 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const K y = __shfl_xor_sync(kFull, x[e], d);
        const bool asc = ((tid * E + e) & kk) == 0;
        x[e] = (lower == asc) ? min(x[e], y) : max(x[e], y);
      }
    }
#pragma unroll
    for (int jj = E / 2; jj > 0; jj >>= 1) {
      if (jj <= j) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & jj) continue;
          const bool asc = ((tid * E + e) & kk) == 0;
          const K a = x[e], b = x[e + jj];
          if ((a > b) == asc) {
            x[e] = b;
            x[e + jj] = a;
          }
        }
      }
    }
  }
}

// Ascending sort of the n keys in memory (G: device memory) by the flip
// form of the bitonic network over next_pow2(n): each merge's first stage
// compares i with its mirror in the other half, the later stages i with
// i + j, always the smaller key to the lower index.  The keys past n are
// virtual maxima that never move, so a comparison with a partner at n or
// past it is skipped.  A barrier a stage.
template <int NTH, bool G>
__device__ void sort_flip(unsigned long long* keys, int n) {
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  for (int kk = 2; kk <= p2; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int c = threadIdx.x; c < p2 / 2; c += NTH) {
        const int i = 2 * c - (c & (j - 1));
        const int l = j == kk >> 1 ? i ^ (kk - 1) : i + j;
        if (l < n) {
          const unsigned long long a = ra<G>(keys, i), b = ra<G>(keys, l);
          if (a > b) {
            ra<G>(keys, i) = b;
            ra<G>(keys, l) = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The per-bin count at a sorted tuple from the segmented sum v up to it:
// the sum since the last start, or cum2 + 1 where no tuple up to here
// starts a segment (the plain version's seg_base of -1).
__device__ __forceinline__ int seg_count(unsigned long long v) {
  const int s = static_cast<int>(v & 0xFFFFFFFFull);
  return (v >> 32) ? s : s + 1;
}

// The per-bin counts over the n_t sorted keys by one segmented scan (k
// at a bin's first valid tuple, min(k, offset delta) after it), NTH
// threads over contiguous runs, and each bin's first crossing of
// threshold flagged in fc by t.  The caller synchronises before fc is
// read.
template <int NTH, bool G, bool GT>
__device__ void mark_first_crossings(const unsigned long long* keys,
                                     const uint32_t* hitv, const int* toffv,
                                     uint8_t* fc, int n_t, int k,
                                     int threshold, long long* sh) {
  const int E = (n_t + NTH - 1) / NTH;
  const int i0 = min(static_cast<int>(threadIdx.x) * E, n_t);
  const int i1 = min(i0 + E, n_t);
  // (segment start << 32 | inc) of the tuple at i, pv its predecessor.
  auto seg = [&](int i, Tuple* pv) -> unsigned long long {
    const Tuple u = tuple_at<G, GT>(keys, hitv, toffv, i);
    const bool ss = (i == 0 || u.bin != pv->bin) && u.valid;
    const int delta = i == 0 ? 0 : u.off - pv->off;
    const int inc = u.valid ? (ss ? k : min(delta, k)) : 0;
    *pv = u;
    return static_cast<unsigned long long>(ss) << 32 |
           static_cast<uint32_t>(inc);
  };
  Tuple prev0{0, 0, 0, false};
  if (i0 > 0 && i0 < n_t) prev0 = tuple_at<G, GT>(keys, hitv, toffv, i0 - 1);
  unsigned long long mine = 0;
  {
    Tuple pv = prev0;
    for (int i = i0; i < i1; ++i) mine = SegSum()(mine, seg(i, &pv));
  }
  unsigned long long unused;
  unsigned long long cur = block_excl<NTH>(mine, 0ull, SegSum(), sh,
                                           &unused);
  // The predecessor's crossing: cur is the scan up to it.
  bool prev_cross = i0 > 0 && i0 < n_t && prev0.valid &&
                    seg_count(cur) >= threshold;
  Tuple pv = prev0;
  for (int i = i0; i < i1; ++i) {
    const unsigned long long v = seg(i, &pv);
    cur = SegSum()(cur, v);
    const bool cross = pv.valid && seg_count(cur) >= threshold;
    if (cross && !(prev_cross && !(v >> 32))) ra<G>(fc, pv.t) = 1;
    prev_cross = cross;
  }
}

// The first crossings in t order (fc, n_t flags, NTH threads over
// contiguous runs), the first min(crossings, max_candidates, cand_max) of
// them to a read's output rows hrow (hit) and orow (offset), hfill and
// -1 after them.  Returns the crossings.
template <int NTH, bool G, bool GT, typename H>
__device__ int write_crossings(const uint8_t* fc, const uint32_t* hitv,
                               const int* toffv, int n_t,
                               int max_candidates, int cand_max, H* hrow,
                               H hfill, int* orow, long long* sh) {
  const int tid = threadIdx.x;
  const int E = (n_t + NTH - 1) / NTH;
  const int j0 = min(tid * E, n_t), j1 = min(j0 + E, n_t);
  int nf = 0;
  for (int t = j0; t < j1; ++t) nf += ra<G>(fc, t);
  int n_emit;
  int o = block_excl<NTH>(nf, 0, Sum(), sh, &n_emit);
  const int n = min(min(n_emit, max_candidates), cand_max);
  for (int t = j0; t < j1 && o < n; ++t) {
    if (ra<G>(fc, t)) {
      at(hrow, o) = static_cast<H>(ra<GT>(hitv, t));
      at(orow, o) = ra<GT>(toffv, t);
      ++o;
    }
  }
  for (int c = n + tid; c < cand_max; c += NTH) {
    at(hrow, c) = hfill;
    at(orow, c) = -1;
  }
  return n_emit;
}

}  // namespace
