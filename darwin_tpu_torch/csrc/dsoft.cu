// Device D-SOFT over a batch of read-strands, for Hopper (sm_90a).
//
// Replaces: darwin_tpu/dsoft/device.py, dsoft_device_batch (line 341),
// which runs _dsoft_one (line 99) under jax.vmap: plain XLA, not Pallas,
// some 40 ops over [R, L+16] and [R, tup_max] arrays with two stable
// sorts.  Its plain PyTorch version is darwin_tpu_torch/dsoft/device.py::
// dsoft_device_batch_torch.
//
// What it computes, per read-strand r (the reference's DSOFT,
// seed_pos_table.cpp:100-167):
//   1. the minimizer scan over positions lo = w-1 .. hi-1, hi =
//      16*ceil(qlen/16) - k - w (bytes at and after qlen code 0): the
//      window minimum m of the k-mer hashes, a change point where m
//      differs from the previous position's (0 before lo), emission at
//      change points and every w positions after the last one (the
//      first run anchored at the virtual p = 0);
//   2. the (start, end) range of each emitted minimizer's hash in the
//      seed table (INDEX: binary search over the sorted hashes, a dense
//      CSR over 4^k hashes, or the two-level index), occ = end - start;
//      minimizers with occ <= kmer_max_occ pass, and the first
//      num_seeds_cap + 1 of them are kept (check before increment);
//   3. the kept minimizers' occ tuples (hit = pos[start + i], offset =
//      the minimizer's position) in emission order, t < min(total,
//      tup_max); a tuple is valid when hit >= offset (uint32), its bin
//      (int32)((hit - offset) / bin_size), invalid ones INT32_MAX;
//   4. the tuples sorted by (bin, t) (t unique: any sort is stable), the
//      per-bin count as a segmented prefix sum (k at a bin's first
//      tuple, min(k, offset delta) after it) and each bin's first
//      crossing of threshold;
//   5. the first crossings in t order: hits [r, :n] (uint32 values in
//      int64), offsets, n = min(crossings, max_candidates, cand_max),
//      0xFFFFFFFF / -1 after them; overflow = total > tup_max or
//      min(crossings, max_candidates) > cand_max.
//
// What bounds it on the H100: the index gathers.  Each emitted
// minimizer's lookup is a chain of dependent loads from the index (the
// two-level index: the bucket-directory pair, `steps` binary-refine
// loads and a verify load inside one bucket of at most 2^steps distinct
// hashes, and the CSR pair; about four 32-byte sectors, most from DRAM:
// the E.coli-shaped index is tens of MB), and each kept minimizer's hits
// a contiguous run of table_pos.  The reads' bytes up to where the scan
// stops, the sort's compare-exchanges and the scans are small beside
// those sectors; chip_smoke.py counts both sides from the run's data,
// each distinct sector once (dsoft_work, dsoft_bound).
//
// Design: one block of NT = 512 threads a read-strand.  The scan runs
// over the read in chunks of NT positions, a thread a position; the
// codes and hashes of a chunk (and its w-position halo) go through
// shared memory, and block scans carry the last change point, the
// passing count and the tuple total from chunk to chunk.  The scan
// stops after the chunk that reaches the num_seeds_cap + 1-th passing
// minimizer or overflows the tuple budget: nothing after it can change
// the output.  Kept minimizers that own a slot below tup_max go to a
// list (position, start, first slot); a tuple finds its minimizer by a
// binary search of the first slots.  The (bin, t) keys, 64 bits, are
// sorted by a bitonic network over next_pow2(min(total, tup_max))
// entries, not tup_max.  The segmented count and the first crossings
// are three passes of block scans over contiguous runs of the sorted
// keys, each thread recomputing its run's predecessor, and a flag by t
// plus a block scan compacts the crossings in t order.  A read's arrays
// (keys, hit and offset by t, flags, the kept list; Layout) live in
// dynamic shared memory when they fit (kSmemArrays; tup_max 8192: 145
// KB), else in a scratch area of device memory a block (G), the blocks
// then looping over the reads; every global access goes through dtt::at.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

using dtt::at;

constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr int kMaxW = 16;   // w < k <= 15
constexpr int kMaxK = 15;
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ constexpr long long r16(long long n) {
  return (n + 15) & ~15ll;
}

// A read's arrays, each 16-byte aligned (byte offsets): the sort keys
// over next_pow2(tup_max), hit and offset by t, a first-crossing flag by
// t, and (position, start, first slot) of each kept minimizer that owns
// a slot (at most num_seeds_cap + 1 of them, and at most tup_max).
struct Layout {
  long long hitv, toffv, fc, kpos, kstart, kcumb, bytes;
  __host__ __device__ Layout(int tup_max, int num_seeds_cap) {
    long long p2 = 1;
    while (p2 < tup_max) p2 <<= 1;
    long long kept = static_cast<long long>(num_seeds_cap) + 1;
    kept = kept < tup_max ? kept : tup_max;
    kept = kept > 1 ? kept : 1;
    hitv = r16(8 * p2);
    toffv = hitv + r16(4ll * tup_max);
    fc = toffv + r16(4ll * tup_max);
    kpos = fc + r16(tup_max);
    kstart = kpos + r16(4 * kept);
    kcumb = kstart + r16(4 * kept);
    bytes = kcumb + r16(4 * kept);
  }
};

// A read's arrays go to dynamic shared memory up to this many bytes (with
// the kernel's static 4.5 KB, within the SM's 227 KB), else to a scratch
// area a block in device memory.
constexpr long long kSmemArrays = 200 * 1024;

// A read's arrays: in shared memory (G false) or a block's scratch area
// in device memory (G true, accesses checked).
template <bool G, typename T>
__device__ __forceinline__ T& ra(T* p, ptrdiff_t i) {
  if constexpr (G) {
    return at(p, i);
  } else {
    return p[i];
  }
}

__device__ __forceinline__ uint32_t code_of(uint8_t b) {
  const uint32_t c = b | 0x20u;
  return c == 'c' ? 1u : c == 'g' ? 2u : c == 't' ? 3u : 0u;
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

// Block-wide exclusive scan of v (identity id); *total gets the block's
// reduction.  sh: NW entries of shared memory, free again on return.
template <typename T, typename Op>
__device__ T block_excl(T v, T id, Op op, T* sh, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = op(x, y);
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  T pre = id, tot = id;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (i < warp) pre = op(pre, sh[i]);
    tot = op(tot, sh[i]);
  }
  __syncthreads();
  T ex = __shfl_up_sync(kFull, x, 1);
  ex = lane == 0 ? id : ex;
  *total = tot;
  return op(pre, ex);
}

struct Index {
  const uint32_t* h;  // sorted hashes (0) / distinct hashes hd (2)
  const int* csr;     // dense CSR (1) / crs (2)
  const int* bkt;     // bucket directory (2)
  const int* base;
  const int* shift;
  int nh, nb, steps;
};

// (start, end) of hash hv in the seed table.
template <int INDEX>
__device__ void lookup(const Index& ix, uint32_t hv, int* start, int* end) {
  if constexpr (INDEX == 0) {  // lower and upper bound of hv
    int lo = 0, hi = ix.nh;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (at(ix.h, mid) < hv) lo = mid + 1; else hi = mid;
    }
    int lo2 = lo;
    hi = ix.nh;
    while (lo2 < hi) {
      const int mid = (lo2 + hi) >> 1;
      if (at(ix.h, mid) <= hv) lo2 = mid + 1; else hi = mid;
    }
    *start = lo;
    *end = lo2;
  } else if constexpr (INDEX == 1) {
    const int h = min(static_cast<int>(hv), ix.nh - 1);
    *start = at(ix.csr, h);
    *end = at(ix.csr, h + 1);
  } else {  // darwin_tpu's twolevel_lookup
    const int rel = static_cast<int>(hv) - at(ix.base, 0);
    const int b = static_cast<int>(static_cast<unsigned>(max(rel, 0)) >>
                                   at(ix.shift, 0));
    const bool bvalid = rel >= 0 && b < ix.nb;
    const int bc = min(b, ix.nb - 1);
    int lo = at(ix.bkt, bc), hi = at(ix.bkt, bc + 1);
    for (int s = 0; s < ix.steps; ++s) {
      if (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const uint32_t v = at(ix.h, min(max(mid, 0), ix.nh - 1));
        if (v < hv) lo = mid + 1; else hi = mid;
      }
    }
    const int d = min(lo, ix.nh - 1);
    const bool found = bvalid && lo < ix.nh && at(ix.h, d) == hv;
    *start = found ? at(ix.csr, d) : 0;
    *end = found ? at(ix.csr, d + 1) : 0;
  }
}

struct Params {
  const uint8_t* queries;
  const int* qlens;
  int R, L;
  Index ix;
  const uint32_t* tpos;
  int k, w, bin_size, kmer_max_occ, num_seeds_cap, threshold;
  int max_candidates, tup_max, cand_max;
  uint8_t* scratch;
  long long* hits;
  int* offs;
  int* counts;
  uint8_t* overflow;
};

// The sorted tuple at i: its t, bin, offset and validity.
struct Tuple {
  int t, bin, off;
  bool valid;
};

template <bool G>
__device__ __forceinline__ Tuple tuple_at(const unsigned long long* keys,
                                          const uint32_t* hitv,
                                          const int* toffv, int i) {
  const unsigned long long key = ra<G>(keys, i);
  Tuple u;
  u.t = static_cast<int>(key & 0xFFFFFFFFull);
  u.bin = static_cast<int>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
  u.off = ra<G>(toffv, u.t);
  u.valid = ra<G>(hitv, u.t) >= static_cast<uint32_t>(u.off);
  return u;
}

template <int INDEX, bool G>
__global__ void __launch_bounds__(NT) dsoft_kernel(Params P) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t cbuf[NT + kMaxW + kMaxK + 1];
  __shared__ uint32_t hbuf[NT + kMaxW];
  __shared__ int sh_i[NW];
  __shared__ long long sh_l[NW];

  const int tid = threadIdx.x;
  const Layout lay(P.tup_max, P.num_seeds_cap);
  uint8_t* base = G ? P.scratch + blockIdx.x * lay.bytes : smem;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base);
  uint32_t* hitv = reinterpret_cast<uint32_t*>(base + lay.hitv);
  int* toffv = reinterpret_cast<int*>(base + lay.toffv);
  uint8_t* fc = base + lay.fc;
  int* kpos = reinterpret_cast<int*>(base + lay.kpos);
  int* kstart = reinterpret_cast<int*>(base + lay.kstart);
  int* kcumb = reinterpret_cast<int*>(base + lay.kcumb);

  const Index ix = P.ix;
  const int k = P.k, w = P.w;
  const uint32_t hmask = (1u << (2 * k)) - 1u;
  const int lo = w - 1;
  // The first num_seeds_cap + 1 passing minimizers are kept.
  const long long cap1 = static_cast<long long>(P.num_seeds_cap) + 1;

  for (int r = blockIdx.x; r < P.R; r += gridDim.x) {
    const uint8_t* q = P.queries + static_cast<size_t>(r) * P.L;
    const int qlen = at(P.qlens, r);
    const int qend = min(max(qlen, 0), P.L);  // bytes past it code 0
    const int hi = 16 * ((qlen + 15) / 16) - k - w;
    int anchor = 0, nseen = 0, nkept = 0;
    long long total = 0;

    // 1-2. The minimizer scan and lookups, NT positions a chunk.
    for (int cs = lo; cs < hi && nseen < cap1 && total <= P.tup_max;
         cs += NT) {
      // Codes of positions cs - w .. cs + NT + k - 2.
      __syncthreads();
      for (int i = tid; i < NT + w + k - 1; i += NT) {
        const int p = cs - w + i;
        cbuf[i] = p >= 0 && p < qend ? code_of(at(q, p)) : 0u;
      }
      __syncthreads();
      // Hashes of positions cs - w .. cs + NT - 1.
      for (int i = tid; i < NT + w; i += NT) {
        uint32_t seed = 0;
        for (int t = 0; t < k; ++t) seed |= cbuf[i + t] << (2 * t);
        hbuf[i] = hash32(seed, hmask);
      }
      __syncthreads();
      const int p = cs + tid;
      const int i = tid + w;  // hbuf index of p
      uint32_t m = hbuf[i], mp = hbuf[i - 1];
      for (int s = 1; s < w; ++s) {
        m = min(m, hbuf[i - s]);
        mp = min(mp, hbuf[i - 1 - s]);
      }
      if (p == lo) mp = 0;  // initial last_m = 0
      const bool in_range = p < hi;
      const bool change = in_range && m != mp;
      int last;
      const int ex_anchor = block_excl(change ? p : -1, -1, Max(), sh_i,
                                       &last);
      const int a = max(anchor, max(ex_anchor, change ? p : -1));
      anchor = max(anchor, last);
      const int offset = p - a;
      const bool emit =
          in_range && (change || (offset % w == 0 && offset > 0));
      int start = 0, occ = 0;
      if (emit) {
        int end;
        lookup<INDEX>(ix, m, &start, &end);
        occ = end - start;
      }
      const bool passing = emit && occ <= P.kmer_max_occ;
      int n_pass;
      const int rank = nseen + block_excl(passing ? 1 : 0, 0, Sum(), sh_i,
                                          &n_pass) + 1;
      const bool keep = passing && rank <= cap1;
      const int cnt = keep ? occ : 0;
      long long n_cnt;
      const long long cumb =
          total + block_excl(static_cast<long long>(cnt), 0ll, Sum(), sh_l,
                             &n_cnt);
      // A kept minimizer owning a slot below tup_max: to the list.
      const bool store = cnt > 0 && cumb < P.tup_max;
      int n_store;
      const int idx =
          nkept + block_excl(store ? 1 : 0, 0, Sum(), sh_i, &n_store);
      if (store) {
        ra<G>(kpos, idx) = p;
        ra<G>(kstart, idx) = start;
        ra<G>(kcumb, idx) = static_cast<int>(cumb);
      }
      nseen += n_pass;
      total += n_cnt;
      nkept += n_store;
    }

    // 3. Tuples t < n_t: (bin, t) keys, hit and offset by t.
    const int n_t = static_cast<int>(min(total, static_cast<long long>(
                                                    P.tup_max)));
    int p2 = 1;
    while (p2 < n_t) p2 <<= 1;
    __syncthreads();  // the kept list is complete
    for (int t = tid; t < p2; t += NT) {
      if (t >= n_t) {
        ra<G>(keys, t) = ~0ull;
        continue;
      }
      int lo_k = 0, hi_k = nkept - 1;  // the last kcumb <= t
      while (lo_k < hi_k) {
        const int mid = (lo_k + hi_k + 1) >> 1;
        if (ra<G>(kcumb, mid) <= t) lo_k = mid; else hi_k = mid - 1;
      }
      const uint32_t hit = at(P.tpos, static_cast<long long>(
                                          ra<G>(kstart, lo_k)) +
                                          t - ra<G>(kcumb, lo_k));
      const int toff = ra<G>(kpos, lo_k);
      const bool valid = hit >= static_cast<uint32_t>(toff);
      const int bin =
          valid ? static_cast<int>((hit - static_cast<uint32_t>(toff)) /
                                   static_cast<uint32_t>(P.bin_size))
                : INT_MAX;
      ra<G>(keys, t) =
          static_cast<unsigned long long>(static_cast<uint32_t>(bin) ^
                                          0x80000000u) << 32 |
          static_cast<uint32_t>(t);
      ra<G>(hitv, t) = hit;
      ra<G>(toffv, t) = toff;
      ra<G>(fc, t) = 0;
    }
    __syncthreads();

    // 4a. Bitonic sort of the p2 keys, ascending.
    for (int kk = 2; kk <= p2; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        for (int c = tid; c < p2 / 2; c += NT) {
          const int i = 2 * c - (c & (j - 1));
          const int ij = i + j;
          const unsigned long long x = ra<G>(keys, i);
          const unsigned long long y = ra<G>(keys, ij);
          if ((x > y) == ((i & kk) == 0)) {
            ra<G>(keys, i) = y;
            ra<G>(keys, ij) = x;
          }
        }
        __syncthreads();
      }
    }

    // 4b. The per-bin counts and first crossings over contiguous runs
    // of the sorted tuples, a run a thread.
    const int E = (n_t + NT - 1) / NT;
    const int i0 = min(tid * E, n_t), i1 = min(i0 + E, n_t);
    // inc_i: k at a bin's first valid tuple, min(k, offset delta) after.
    auto step = [&](int i, Tuple* prev, bool* seg_start) -> int {
      const Tuple u = tuple_at<G>(keys, hitv, toffv, i);
      const bool first = i == 0 || u.bin != prev->bin;
      *seg_start = first && u.valid;
      const int delta = i == 0 ? 0 : u.off - prev->off;
      *prev = u;
      return u.valid ? (*seg_start ? k : min(delta, k)) : 0;
    };
    Tuple prev0{0, 0, 0, false};
    if (i0 > 0 && i0 < n_t) prev0 = tuple_at<G>(keys, hitv, toffv, i0 - 1);
    int sum_loc = 0;
    {
      Tuple pv = prev0;
      bool ss;
      for (int i = i0; i < i1; ++i) sum_loc += step(i, &pv, &ss);
    }
    int unused;
    const int inc_pre = block_excl(sum_loc, 0, Sum(), sh_i, &unused);
    int max_loc = INT_MIN;
    {
      Tuple pv = prev0;
      bool ss;
      int c2 = inc_pre;
      for (int i = i0; i < i1; ++i) {
        const int inc = step(i, &pv, &ss);
        c2 += inc;
        max_loc = max(max_loc, ss ? c2 - inc : -1);
      }
    }
    const int base_pre = block_excl(max_loc, INT_MIN, Max(), sh_i, &unused);
    {
      // The predecessor's crossing: its cum2 is inc_pre, its segment
      // base base_pre.
      bool prev_cross = i0 > 0 && i0 < n_t && prev0.valid &&
                        inc_pre - base_pre >= P.threshold;
      Tuple pv = prev0;
      bool ss;
      int c2 = inc_pre, run = base_pre;
      for (int i = i0; i < i1; ++i) {
        const int inc = step(i, &pv, &ss);
        c2 += inc;
        run = max(run, ss ? c2 - inc : -1);
        const bool cross = pv.valid && c2 - run >= P.threshold;
        if (cross && !(prev_cross && !ss)) ra<G>(fc, pv.t) = 1;
        prev_cross = cross;
      }
    }
    __syncthreads();

    // 5. The first crossings in t order, the first n of them out.
    const int j0 = min(tid * E, n_t), j1 = min(j0 + E, n_t);
    int nf = 0;
    for (int t = j0; t < j1; ++t) nf += ra<G>(fc, t);
    int n_emit;
    int o = block_excl(nf, 0, Sum(), sh_i, &n_emit);
    const int n = min(min(n_emit, P.max_candidates), P.cand_max);
    long long* hrow = P.hits + static_cast<size_t>(r) * P.cand_max;
    int* orow = P.offs + static_cast<size_t>(r) * P.cand_max;
    for (int t = j0; t < j1 && o < n; ++t) {
      if (ra<G>(fc, t)) {
        at(hrow, o) = ra<G>(hitv, t);
        at(orow, o) = ra<G>(toffv, t);
        ++o;
      }
    }
    for (int c = n + tid; c < P.cand_max; c += NT) {
      at(hrow, c) = 0xFFFFFFFFll;
      at(orow, c) = -1;
    }
    if (tid == 0) {
      at(P.counts, r) = n;
      at(P.overflow, r) = total > P.tup_max ||
                          min(n_emit, P.max_candidates) > P.cand_max;
    }
  }
}

template <int INDEX>
int launch_mode(const Params& p, long long bytes, int grid,
                cudaStream_t st) {
  if (bytes > kSmemArrays) {
    dsoft_kernel<INDEX, true><<<grid, NT, 0, st>>>(p);
  } else {
    const auto kernel = dsoft_kernel<INDEX, false>;
    const int smem = static_cast<int>(bytes);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<p.R, NT, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch bytes a block needs in device memory for these budgets: 0
// when a read's arrays fit in shared memory.
extern "C" long long dtt_dsoft_scratch_bytes(int tup_max,
                                             int num_seeds_cap) {
  const Layout lay(tup_max, num_seeds_cap);
  return lay.bytes > kSmemArrays ? lay.bytes : 0;
}

// index: 0 searchsorted (h = the sorted hashes), 1 dense (csr), 2
// twolevel (h = hd, csr = crs, bkt, base, shift).  When
// dtt_dsoft_scratch_bytes is not 0, grid blocks, each with that many
// bytes of scratch, loop over the reads; else one block takes each read
// and grid and scratch are not read.
extern "C" int dtt_dsoft(const uint8_t* queries, const int* qlens, int R,
                         int L, const uint32_t* h, const int* csr,
                         const int* bkt, const int* base, const int* shift,
                         int nh, int nb, int steps, const uint32_t* tpos,
                         int k, int w, int bin_size,
                         int kmer_max_occ, int num_seeds_cap, int threshold,
                         int max_candidates, int tup_max, int cand_max,
                         int index, int grid, uint8_t* scratch,
                         long long* hits, int* offs, int* counts,
                         uint8_t* overflow, void* stream) {
  const long long bytes = Layout(tup_max, num_seeds_cap).bytes;
  if (R <= 0 || L < 0 || k < 4 || k > kMaxK || w < 1 || w >= k ||
      bin_size < 1 || tup_max < 1 || cand_max < 1 || num_seeds_cap < 0 ||
      index < 0 || index > 2 ||
      (bytes > kSmemArrays && (grid < 1 || scratch == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{queries, qlens, R, L,
           Index{h, csr, bkt, base, shift, nh, nb, steps},
           tpos, k, w, bin_size, kmer_max_occ, num_seeds_cap, threshold,
           max_candidates, tup_max, cand_max, scratch,
           hits, offs, counts, overflow};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  switch (index) {
    case 0: return launch_mode<0>(p, bytes, grid, st);
    case 1: return launch_mode<1>(p, bytes, grid, st);
    default: return launch_mode<2>(p, bytes, grid, st);
  }
}
