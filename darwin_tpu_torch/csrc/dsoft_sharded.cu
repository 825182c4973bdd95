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
//   positions lo = w-1 .. hi-1, hi = 16*ceil(qlen/16) - k - w clipped to
//   LP, bytes at and after qlen code 0; a change point where the minimum
//   differs from the previous position's, 0 before lo; emission at
//   change points and every w positions after the last one, the first
//   run anchored at the virtual p = 0), and each emitted minimizer's
//   [start, end) in THIS shard's table: a binary search of its sorted,
//   sentinel-padded hashes (index 0, searchsorted left and right) or its
//   DenseShardIndex (index 1, the two-level probe of twolevel_lookup).
//   Writes emit, start and occ = end - start at every position of [R, LP],
//   0 where nothing is emitted.  No num_seeds cap and no early stop: the
//   cap needs the occurrences summed over the shards.
// * shard_count, a read this shard owns at a time, over the tuples the
//   exchange brought it, grouped by read and in (offset, hit) order
//   within a read (one stable sort each in PyTorch): the read's keys
//   (bin ^ 2^31) << 32 | t, bin the uint32 quotient (hit - offset) /
//   bin_size taken as int32, t the tuple's index in the read, sorted (so
//   by bin, offset, hit), the per-bin counts as one segmented scan (k at
//   a bin's first tuple, min(k, offset delta) after it), each bin's first
//   crossing of threshold, and the first crossings in t order into the
//   read's [cand_max] rows of hits (uint32 bit patterns, -1 after them)
//   and offsets; counts = min(crossings, max_candidates, cand_max) and
//   over_c = min(crossings, max_candidates) > cand_max.
//
// What bounds them on the H100: bytes (chip_smoke.py's shard_scan_bound
// and shard_count_bound): shard_scan writes nine bytes a position of
// every read and loads the index sectors its lookups touch; shard_count
// reads eight bytes a received tuple and writes the output rows.  Both
// kernels are far from it.  shard_scan's time is its lookups' chains of
// dependent loads (about 2 in 5 positions emit) and the hashing and
// window minima of every position; shard_count's is its sort.
//
// Design (the scan's and the count's common pieces are
// dsoft_common.cuh's, shared with the device D-SOFT, dsoft.cu):
//  * shard_scan: kScanThreads = 256 threads a read, chunks of CH = 1024
//    positions from position 0, kScanPP = 4 consecutive positions a
//    thread.  A thread hashes its own positions once, rolling its k-mers
//    over the codes staged in shared memory (the next chunk's bytes are
//    loaded into registers at the chunk's top, in flight during its
//    lookups, and staged at its end), and stores the hashes to shared
//    memory (skewed against bank conflicts); after a barrier it takes
//    its window minima from there, w loads a window.  It issues its
//    emitted positions' lookups together (lookup_multi; the two-level
//    index in three rounds of loads: the bucket's bounds, all its
//    hashes, the CSR pair) and stores its four emit bytes as one 32-bit
//    word and its starts and occurrences as one 16-byte vector each,
//    streaming (evict-first) so that the outputs do not push the index
//    out of L2 (when LP % 4 == 0; else a position at a time).  Three
//    barriers a chunk: the hashes, the block max scan of the run anchor
//    and the chunk's end.  Chunks from hi on are written as zeros,
//    unscanned.  Four blocks an SM.
//  * shard_count, three forms in one call, no host sync: count_small, a
//    block of kCountThreads = 256 a read, takes a read of up to
//    kRegTuples = 1024 tuples: its keys kCountES = 4 a thread in
//    registers, as 32 bits where the read's bins allow, sorted by
//    sort_keys (strides below 128 in registers and shuffles, the rest
//    through shared memory), then the segmented scan and the compaction
//    from shared memory.  count_large, a block of 512 an SM looping over
//    the longer reads, sorts a read of up to kSmemTuples in dynamic
//    shared memory (n keys and n flags) by the flip form of the bitonic
//    network, whose comparisons with a partner past n are skipped, so n
//    keys of storage suffice; past kSmemTuples, in the same way in device
//    memory (the read's keys at 8 * seg[r] and its flags at r16(8N) +
//    seg[r] of a scratch area that the wrapper sizes from N alone).
//    Every global access goes through dtt::at.

#include <cstdint>
#include <cuda_runtime.h>

#include "dsoft_common.cuh"

namespace {

// shard_scan's threads a block and consecutive positions a thread.
constexpr int kScanThreads = 256;
constexpr int kScanPP = CH / kScanThreads;
// shard_count: the register form's threads, tuple budget and keys a
// thread; the longer reads' threads and the dynamic shared memory that
// holds such a read's n keys and n flags (within the 227 KB a block may
// take, beside count_large's static 256 bytes).
constexpr int kCountThreads = 256;
constexpr int kRegTuples = 1024;
constexpr int kCountES = kRegTuples / kCountThreads;
constexpr int kLargeThreads = 512;
constexpr long long kSmemBytes = 200 * 1024;
constexpr int kSmemTuples = 22752;
static_assert(r16(8ll * kSmemTuples) + r16(kSmemTuples) <= kSmemBytes,
              "a read of kSmemTuples fits kSmemBytes");
static_assert(kScanPP % 4 == 0, "whole 32-bit words of emit bytes");

// ---- shard_scan ---------------------------------------------------------

// A chunk's k-mer hashes in shared memory: position cs - kHalo + i at
// skew(i), a word skipped every 32 so that a warp's window loads (four
// words apart from thread to thread) fall in distinct banks.
constexpr int kHalo = 16;  // >= w
__host__ __device__ constexpr int skew(int i) { return i + (i >> 5); }

// INDEX: lookup_multi's mode, 0 searchsorted or 3 the two-level index
// (each bucket's hashes in one round).
template <int INDEX>
__global__ void __launch_bounds__(kScanThreads, 1024 / kScanThreads)
    shard_scan(const uint8_t* queries, const int* qlens, int L, int LP,
               Index ix, int k, int w, uint8_t* emit, int* start,
               int* occ) {
  constexpr int NTH = kScanThreads, PP = kScanPP;
  constexpr int NL = (CHB + NTH - 1) / NTH;
  __shared__ uint8_t code[2][CHB];
  __shared__ uint32_t s_hash[skew(kHalo + CH - 1) + 1];
  __shared__ long long sh[NTH / 32];
  const int tid = threadIdx.x, r = blockIdx.x;
  const uint8_t* q = queries + static_cast<size_t>(r) * L;
  const int qlen = at(qlens, r);
  const int qend = min(max(qlen, 0), L);  // bytes past it code 0
  const int lo = w - 1;
  const int hi = min(16 * ((qlen + 15) / 16) - k - w, LP);
  const int shi = lo < hi ? hi : 0;  // chunks below it are scanned
  const uint32_t hmask = (1u << (2 * k)) - 1u;
  const int win = CH + w + k - 1;  // staged codes: positions cs - w ..
  const int ixbase = INDEX == 3 ? at(ix.base, 0) : 0;
  const int ixshift = INDEX == 3 ? at(ix.shift, 0) : 0;
  const size_t row = static_cast<size_t>(r) * LP;
  const bool vec = (LP & 3) == 0;  // row + p0 is a multiple of 4

  if (shi > 0) {
    uint8_t b[NL];
    load_chunk<NTH>(q, qend, -w, win, b);
    stage_chunk<NTH>(code[0], b);
  }
  __syncthreads();
  int anchor = 0;  // the last change point before the chunk (virtual 0)
  for (int c = 0, cs = 0; cs < LP; ++c, cs += CH) {
    const int p0 = cs + tid * PP;
    bool em[PP];
    int st[PP], en[PP];
    if (cs < shi) {  // block-uniform
      // The next chunk's bytes, in flight during this chunk's lookups.
      const bool next = cs + CH < shi;
      uint8_t pre[NL];
      if (next) load_chunk<NTH>(q, qend, cs + CH - w, win, pre);
      // This thread's PP hashes, rolled over the staged codes (index j is
      // position cs - w + j), and thread i < w's hash of position cs - w
      // + i, the first windows' halo.
      const uint8_t* cc = code[c & 1];
      const uint8_t* own = cc + w + tid * PP;  // position p0
      uint32_t seed = 0;
      for (int t = 0; t + 1 < k; ++t) seed |= static_cast<uint32_t>(own[t])
                                              << (2 * (t + 1));
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        seed = (seed >> 2) | (static_cast<uint32_t>(own[e + k - 1])
                              << (2 * (k - 1)));
        s_hash[skew(kHalo + tid * PP + e)] = hash32(seed, hmask);
      }
      if (tid < w) {
        seed = 0;
        for (int t = 0; t < k; ++t) seed |= static_cast<uint32_t>(cc[tid + t])
                                            << (2 * t);
        s_hash[skew(kHalo - w + tid)] = hash32(seed, hmask);
      }
      __syncthreads();
      // mm[i]: the window minimum at p0 - 1 + i, over positions p0 - w + i
      // .. p0 - 1 + i; so m[e] = mm[e + 1] and mp[e] = mm[e].
      uint32_t mm[PP + 1];
#pragma unroll
      for (int i = 0; i <= PP; ++i) mm[i] = 0xFFFFFFFFu;
      for (int j = 0; j < w; ++j) {
#pragma unroll
        for (int i = 0; i <= PP; ++i) {
          mm[i] = min(mm[i], s_hash[skew(kHalo + tid * PP - w + i + j)]);
        }
      }
      uint32_t m[PP], mp[PP];
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        m[e] = mm[e + 1];
        mp[e] = mm[e];
      }
      bool inr[PP], chg[PP];
      int lc = -1;  // this thread's last change point
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        const int p = p0 + e;
        inr[e] = p >= lo && p < hi;
        chg[e] = inr[e] && m[e] != (p == lo ? 0u : mp[e]);  // last_m = 0
        if (chg[e]) lc = p;
      }
      int last;
      int a = max(anchor, block_excl<NTH>(lc, -1, Max(), sh, &last));
      anchor = max(anchor, last);
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        const int p = p0 + e;
        if (chg[e]) a = p;
        const int offset = p - a;
        em[e] = inr[e] && (chg[e] || (offset % w == 0 && offset > 0));
      }
      lookup_multi<INDEX, PP>(ix, ixbase, ixshift, m, em, st, en);
      if (next) stage_chunk<NTH>(code[(c + 1) & 1], pre);
      __syncthreads();  // this chunk's readers of code, s_hash, sh are done
    } else {
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        em[e] = false;
        st[e] = en[e] = 0;
      }
    }
    if (vec) {
#pragma unroll
      for (int g = 0; g < PP / 4; ++g) {
        if (p0 + 4 * g >= LP) break;
        const int e = 4 * g;
        // Streaming stores: the outputs pass through L2 without
        // evicting the index.
        __stcs(&at(reinterpret_cast<unsigned*>(emit + row + p0), g),
               static_cast<unsigned>(em[e]) |
                   static_cast<unsigned>(em[e + 1]) << 8 |
                   static_cast<unsigned>(em[e + 2]) << 16 |
                   static_cast<unsigned>(em[e + 3]) << 24);
        __stcs(&at(reinterpret_cast<int4*>(start + row + p0), g),
               make_int4(st[e], st[e + 1], st[e + 2], st[e + 3]));
        __stcs(&at(reinterpret_cast<int4*>(occ + row + p0), g),
               make_int4(en[e] - st[e], en[e + 1] - st[e + 1],
                         en[e + 2] - st[e + 2], en[e + 3] - st[e + 3]));
      }
    } else {
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        if (p0 + e < LP) {
          at(emit, row + p0 + e) = em[e];
          at(start, row + p0 + e) = st[e];
          at(occ, row + p0 + e) = en[e] - st[e];
        }
      }
    }
  }
}

// ---- shard_count --------------------------------------------------------

struct CountParams {
  const uint32_t* hit;  // the shard's N tuples, by (read, offset, hit)
  const int* off;
  const long long* seg;  // [R + 1]: read r's tuples are seg[r] .. seg[r+1]
  long long N;
  int R, k, bin_size, threshold, max_candidates, cand_max;
  // The device-memory form's scratch: read r's keys at byte 8 * seg[r],
  // its flags at r16(8 * N) + seg[r].
  uint8_t* scratch;
  int* hits;
  int* offs;
  int* counts;
  uint8_t* over;
};

// Read r's first crossings (n tuples) to its output rows, its count and
// its flag.
template <int NTH, bool G, bool GT>
__device__ void count_out(const CountParams& P, int r, int n,
                          const uint8_t* fc, const uint32_t* hitv,
                          const int* toffv, long long* sh) {
  const int n_emit = write_crossings<NTH, G, GT>(
      fc, hitv, toffv, n, P.max_candidates, P.cand_max,
      P.hits + static_cast<size_t>(r) * P.cand_max, -1,
      P.offs + static_cast<size_t>(r) * P.cand_max, sh);
  if (threadIdx.x == 0) {
    at(P.counts, r) = min(min(n_emit, P.max_candidates), P.cand_max);
    at(P.over, r) = min(n_emit, P.max_candidates) > P.cand_max;
  }
}

// The greater halves, each on its own, of two (hi << 32 | lo) pairs.
struct HalfMax {
  __device__ unsigned long long operator()(unsigned long long a,
                                           unsigned long long b) const {
    return max(a >> 32, b >> 32) << 32 |
           max(a & 0xFFFFFFFFull, b & 0xFFFFFFFFull);
  }
};

// A read of at most kRegTuples tuples a block: hit and offset staged in
// shared memory, the keys sorted in registers, the counts and the
// compaction from shared memory.  Where the read's u = bin ^ 2^31 span
// less than 2^22 - 1, the keys sort as 32 bits, (u - least u) << 10 | t
// (t < 1024; the greatest stays below the padding's ~0), in the same
// order as the 64-bit keys, which they become again after the sort.
// Longer reads are count_large's.
__global__ void __launch_bounds__(kCountThreads) count_small(CountParams P) {
  constexpr int NTH = kCountThreads, ES = kCountES;
  __shared__ uint32_t s_hit[kRegTuples];
  __shared__ int s_off[kRegTuples];
  __shared__ uint8_t s_fc[kRegTuples];
  // sort_keys' stages (64-bit keys), then the sorted keys.
  __shared__ unsigned long long s_keys[kRegTuples];
  __shared__ uint32_t s_keys32[kRegTuples];  // sort_keys' (32-bit keys)
  __shared__ long long sh[2][NTH / 32];
  const int tid = threadIdx.x, r = blockIdx.x;
  const long long s0 = at(P.seg, r);
  const int n = static_cast<int>(at(P.seg, r + 1) - s0);
  if (n > kRegTuples) return;
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    const int t = tid + e * NTH;
    if (t < n) {
      s_hit[t] = at(P.hit, s0 + t);
      s_off[t] = at(P.off, s0 + t);
      s_fc[t] = 0;
    }
  }
  __syncthreads();
  unsigned long long x[ES];
  unsigned long long span = 0;  // greatest u << 32 | ~(least u)
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    const int t = tid * ES + e;
    x[e] = t < n ? tuple_key(s_hit[t], s_off[t], t, P.bin_size) : ~0ull;
    const unsigned long long u = x[e] >> 32;
    if (t < n) span = HalfMax()(span, u << 32 | (~u & 0xFFFFFFFFull));
  }
  unsigned long long all;
  block_excl<NTH>(span, 0ull, HalfMax(), sh[0], &all);
  const uint32_t umax = static_cast<uint32_t>(all >> 32);
  const uint32_t umin = ~static_cast<uint32_t>(all);
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  if (n > 0 && umax - umin < (1u << 22) - 1) {  // block-uniform
    uint32_t y[ES];
#pragma unroll
    for (int e = 0; e < ES; ++e) {
      const int t = tid * ES + e;
      y[e] = t < n ? (static_cast<uint32_t>(x[e] >> 32) - umin) << 10 |
                         static_cast<uint32_t>(t)
                   : ~0u;
    }
    sort_keys<NTH, ES>(y, p2, s_keys32);
#pragma unroll
    for (int e = 0; e < ES; ++e) {
      x[e] = static_cast<unsigned long long>((y[e] >> 10) + umin) << 32 |
             (y[e] & 1023u);
    }
  } else {
    sort_keys<NTH, ES>(x, p2, s_keys);
  }
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    if (tid * ES + e < n) s_keys[tid * ES + e] = x[e];
  }
  __syncthreads();
  mark_first_crossings<NTH, false, false>(s_keys, s_hit, s_off, s_fc, n, P.k,
                                          P.threshold, sh[0]);
  __syncthreads();
  count_out<NTH, false, false>(P, r, n, s_fc, s_hit, s_off, sh[1]);
}

// Read r's n tuples from s0 with its keys and flags in shared memory (G
// false) or in device memory (G true); hit and offset read in place.
template <bool G>
__device__ void count_large_read(const CountParams& P, int r, long long s0,
                                 int n, unsigned long long* keys, uint8_t* fc,
                                 long long (*sh)[kLargeThreads / 32]) {
  constexpr int NTH = kLargeThreads;
  const uint32_t* hit = P.hit + s0;
  const int* off = P.off + s0;
  for (int t = threadIdx.x; t < n; t += NTH) {
    ra<G>(keys, t) = tuple_key(at(hit, t), at(off, t), t, P.bin_size);
    ra<G>(fc, t) = 0;
  }
  __syncthreads();
  sort_flip<NTH, G>(keys, n);
  mark_first_crossings<NTH, G, true>(keys, hit, off, fc, n, P.k,
                                     P.threshold, sh[0]);
  __syncthreads();
  count_out<NTH, G, true>(P, r, n, fc, hit, off, sh[1]);
}

// The reads past kRegTuples, blocks looping over the reads.
__global__ void __launch_bounds__(kLargeThreads) count_large(CountParams P) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ long long sh[2][kLargeThreads / 32];
  for (int r = blockIdx.x; r < P.R; r += gridDim.x) {
    const long long s0 = at(P.seg, r);
    const int n = static_cast<int>(at(P.seg, r + 1) - s0);
    if (n <= kRegTuples) continue;  // block-uniform
    __syncthreads();  // the previous read's arrays are free
    if (n <= kSmemTuples) {
      count_large_read<false>(P, r, s0, n,
                              reinterpret_cast<unsigned long long*>(smem),
                              smem + r16(8ll * n), sh);
    } else {
      count_large_read<true>(
          P, r, s0, n, reinterpret_cast<unsigned long long*>(P.scratch) + s0,
          P.scratch + r16(8 * P.N) + s0, sh);
    }
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
  const Index ix{h, crs, bkt, base, shift, nh, nb, steps};
  if (index == 0) {
    shard_scan<0><<<R, kScanThreads, 0, st>>>(queries, qlens, L, LP, ix, k,
                                              w, emit, start, occ);
  } else {
    shard_scan<3><<<R, kScanThreads, 0, st>>>(queries, qlens, L, LP, ix, k,
                                              w, emit, start, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

// The scratch bytes a shard_count call over N tuples needs: 0 when no
// read can pass kSmemTuples (N <= kSmemTuples), else r16(8N) + r16(N).
extern "C" long long dtt_shard_count_scratch_bytes(long long N) {
  return N > kSmemTuples ? r16(8 * N) + r16(N) : 0;
}

// hit and off: N tuples (N * k < 2^31); sms: the card's SMs; scratch:
// dtt_shard_count_scratch_bytes(N) bytes, not read when that is 0.
extern "C" int dtt_shard_count(const uint32_t* hit, const int* off,
                               const long long* seg, int R, long long N,
                               int k, int bin_size, int threshold,
                               int max_candidates, int cand_max, int sms,
                               uint8_t* scratch, int* hits, int* offs,
                               int* counts, uint8_t* over, void* stream) {
  const long long need = dtt_shard_count_scratch_bytes(N);
  if (R < 0 || N < 0 || k < 1 || bin_size < 1 || cand_max < 1 || sms < 1 ||
      N * k >= (1ll << 31) || (need > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  const CountParams p{hit, off, seg, N, R, k, bin_size, threshold,
                      max_candidates, cand_max, scratch, hits, offs, counts,
                      over};
  count_small<<<R, kCountThreads, 0, st>>>(p);
  if (N <= kRegTuples) return static_cast<int>(cudaGetLastError());
  const long long want = r16(8 * N) + r16(N);
  const int smem = static_cast<int>(want < kSmemBytes ? want : kSmemBytes);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        count_large, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = R < sms ? R : sms;
  count_large<<<grid, kLargeThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
