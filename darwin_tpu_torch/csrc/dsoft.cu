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
// each distinct sector once (dsoft_work, dsoft_bound).  The kernel is
// far from that bound: a block's time is the scan's instructions and
// its lookups' latency, then the sort (tools/torch_dsoft_phases.py
// times each phase of a block).
//
// Design: two kernels in one call.
//  * dsoft_small, one block of NTS = 256 threads a read-strand, every
//    array of the read in 32 KB of static shared memory and registers,
//    so that four blocks share an SM (64 registers a thread) and the
//    E.coli slice's 920 read-strands run in under two waves.  It takes
//    every read whose tuples, min(total, tup_max), fit kSmemTuples =
//    1024 (the E.coli slice's largest read-strand holds 904; chip_smoke
//    prints the distribution).  A read past it stops scanning as soon as
//    its total passes the budget and is appended to a list.
//  * dsoft_large, the list's reads (launched only when tup_max exceeds
//    the budget; its blocks loop over the list, an empty list costs one
//    short launch): one block of NT = 512 threads a read, its arrays
//    sized by tup_max (Layout, kSmemArrays) in dynamic shared memory, or
//    past kSmemArrays in a scratch area a block in device memory (G).
//    Each writes the read's output rows in place.
// Both scan a read by scan_read, in chunks of CH = 1024 positions, PP
// consecutive positions a thread: the thread rolls its k-mers over codes
// staged in shared memory (the next chunk's bytes are loaded into
// registers at the top of a chunk, in flight while its lookups run, and
// staged at its end), issues the lookups of all its emitted positions
// together (lookup_multi, one round of independent loads per step of
// the chain), and a chunk takes three barriers: a max scan for the run
// anchor, one sum scan of a packed (passing, passing with occ > 0, occ)
// triple, which gives every thread its rank, its slot in the kept list
// and its first tuple slot, and the chunk's end (the num_seeds cap
// applied in the chunk that reaches it).  The scan stops after the
// chunk that reaches the num_seeds_cap + 1-th passing minimizer or
// passes the tuple budget: nothing after it can change the output.
// dsoft_small then holds its read's (bin ^ 2^31) << 32 | t keys in
// registers, ES = 4 a thread, and sorts them by a bitonic network whose
// strides below 128 run in registers and shuffles (only strides of 128
// and up go through shared memory, a barrier a stage); dsoft_large
// sorts in memory, a barrier a stage.  Both then take the per-bin
// counts and first crossings by one segmented scan over the sorted keys
// (mark_first_crossings) and compact the crossings in t order by one
// more scan (write_out): dsoft_small takes at most 16 barriers from the
// end of its scan to its output, where a sort of 1024 keys a block-wide
// stage at a time takes 55; dsoft_large's sort (sort_flip) skips the
// comparisons with the virtual keys past its n.  Every global access
// goes through dtt::at.
// The pieces both kernels share with the table-sharded D-SOFT
// (dsoft_sharded.cu) live in dsoft_common.cuh.

#include <cstdint>
#include <cuda_runtime.h>

#include "dsoft_common.cuh"

namespace {

constexpr int NT = 512;      // dsoft_large's threads
constexpr int NTS = 256;     // dsoft_small's threads
// dsoft_small's tuple budget and its keys a thread.
constexpr int kSmemTuples = 1024;
constexpr int ES = kSmemTuples / NTS;
// A packed sum of (passing, passing with occ > 0, occ clamped to
// kOccClamp): 11, 11 and 42 bits, exact over a chunk of CH positions.
constexpr int kCountBits = 11;
constexpr long long kOccClamp = 1ll << 30;

// dsoft_large's per-read arrays, each 16-byte aligned (byte offsets):
// the sort keys, hit and offset by t, a first-crossing flag by t, and
// (position, start, first slot) of each kept minimizer that owns a slot
// (at most num_seeds_cap + 1 of them, and at most tup_max).
struct Layout {
  long long hitv, toffv, fc, kpos, kstart, kcumb, bytes;
  __host__ __device__ Layout(int tup_max, int num_seeds_cap) {
    long long kept = static_cast<long long>(num_seeds_cap) + 1;
    kept = kept < tup_max ? kept : tup_max;
    kept = kept > 1 ? kept : 1;
    hitv = r16(8ll * tup_max);
    toffv = hitv + r16(4ll * tup_max);
    fc = toffv + r16(4ll * tup_max);
    kpos = fc + r16(tup_max);
    kstart = kpos + r16(4 * kept);
    kcumb = kstart + r16(4 * kept);
    bytes = kcumb + r16(4 * kept);
  }
};

// dsoft_large's arrays go to dynamic shared memory up to this many bytes
// (with its static 2.4 KB, within the SM's 227 KB), else to a scratch
// area a block in device memory.
constexpr long long kSmemArrays = 200 * 1024;

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

// scan_read's shared state: two staged chunks of codes, two scan
// buffers, the kept list's length and the capped total.
struct ScanShared {
  uint8_t code[2][CHB];
  long long sh[2][NT / 32];
  int nkept;
  long long total;
};

// 1-2. The minimizer scan of read r and its lookups, CH = NTH * PP
// positions a chunk.  Kept minimizers owning a slot below lim go to the
// kept list (kpos, kstart, kcumb; at most min(num_seeds_cap + 1, lim)
// of them); the scan stops after the chunk where the num_seeds cap is
// reached or the total passes lim.  Returns the total (each occ capped
// at kOccClamp, so that it compares with any lim < 2^30 as the exact
// total does) and the kept list's length.  Ends in a barrier.
template <int INDEX, int NTH, int PP, bool G>
__device__ void scan_read(const Params& P, int r, long long lim,
                          int ixbase, int ixshift, int* kpos, int* kstart,
                          int* kcumb, ScanShared& S, long long* total_out,
                          int* nkept_out) {
  static_assert(NTH * PP == CH, "a chunk is NTH * PP positions");
  constexpr int NL = (CHB + NTH - 1) / NTH;
  const int tid = threadIdx.x, lane = tid & 31;
  const int k = P.k, w = P.w;
  const uint32_t hmask = (1u << (2 * k)) - 1u;
  const uint8_t* q = P.queries + static_cast<size_t>(r) * P.L;
  const int qlen = at(P.qlens, r);
  const int qend = min(max(qlen, 0), P.L);  // bytes past it code 0
  const int lo = w - 1;
  const int hi = 16 * ((qlen + 15) / 16) - k - w;
  const int win = CH + w + k - 1;  // staged codes: positions cs - w ..
  // The first num_seeds_cap + 1 passing minimizers are kept.
  const long long cap1 = static_cast<long long>(P.num_seeds_cap) + 1;
  int anchor = 0, nkb = 0;
  long long nseen = 0, total = 0;

  if (tid == 0) S.nkept = 0;
  if (lo < hi) {
    uint8_t b[NL];
    load_chunk<NTH>(q, qend, lo - w, win, b);
    stage_chunk<NTH>(S.code[0], b);
  }
  __syncthreads();
  for (int c = 0, cs = lo; cs < hi && nseen < cap1 && total <= lim;
       ++c, cs += CH) {
    // The next chunk's bytes, in flight during this chunk's lookups.
    const bool next = cs + CH < hi;
    uint8_t pre[NL];
    if (next) load_chunk<NTH>(q, qend, cs + CH - w, win, pre);

    // Window minima at p0 + e (m) and at p0 + e - 1 (mp) from the hashes
    // of positions p0 - w + j, j < PP + w, rolled over the staged codes.
    const int p0 = cs + tid * PP;
    const uint8_t* cc = S.code[c & 1] + tid * PP;  // position p0 - w
    uint32_t m[PP], mp[PP];
#pragma unroll
    for (int e = 0; e < PP; ++e) m[e] = mp[e] = 0xFFFFFFFFu;
    uint32_t seed = 0;
    for (int t = 0; t + 1 < k; ++t) seed |= static_cast<uint32_t>(cc[t])
                                            << (2 * (t + 1));
    for (int j = 0; j < PP + w; ++j) {
      seed = (seed >> 2) | (static_cast<uint32_t>(cc[j + k - 1])
                            << (2 * (k - 1)));
      const uint32_t h = hash32(seed, hmask);
#pragma unroll
      for (int e = 0; e < PP; ++e) {
        if (j > e && j <= e + w) m[e] = min(m[e], h);
        if (j >= e && j < e + w) mp[e] = min(mp[e], h);
      }
    }
    bool inr[PP], chg[PP];
    int lc = -1;  // this thread's last change point
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      const int p = p0 + e;
      inr[e] = p < hi;
      chg[e] = inr[e] && m[e] != (p == lo ? 0u : mp[e]);  // last_m = 0
      if (chg[e]) lc = p;
    }
    int last;
    int a = max(anchor, block_excl<NTH>(lc, -1, Max(), S.sh[0], &last));
    anchor = max(anchor, last);
    bool emit[PP];
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      const int p = p0 + e;
      if (chg[e]) a = p;
      const int offset = p - a;
      emit[e] = inr[e] && (chg[e] || (offset % w == 0 && offset > 0));
    }
    int start[PP], end[PP];
    lookup_multi<INDEX, PP>(P.ix, ixbase, ixshift, m, emit, start, end);

    // One scan of (passing, passing with occ > 0, occ) gives each
    // passing minimizer its rank, its kept-list slot and its first
    // tuple slot.
    unsigned long long mine = 0, pk[PP];
    long long occ[PP];
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      occ[e] = min(static_cast<long long>(end[e] - start[e]), kOccClamp);
      const bool pass = emit[e] && end[e] - start[e] <= P.kmer_max_occ;
      pk[e] = pass ? 1ull | (occ[e] > 0 ? 1ull << kCountBits : 0ull) |
                         static_cast<unsigned long long>(occ[e])
                             << (2 * kCountBits)
                   : 0ull;
      mine += pk[e];
    }
    unsigned long long all;
    unsigned long long run =
        block_excl<NTH>(mine, 0ull, Sum(), S.sh[1], &all);
    constexpr unsigned long long cmask = (1ull << kCountBits) - 1;
    int last_idx = -1;
#pragma unroll
    for (int e = 0; e < PP; ++e) {
      if (pk[e]) {
        const long long rank = nseen + static_cast<long long>(run & cmask)
                               + 1;
        const long long cumb =
            total + static_cast<long long>(run >> (2 * kCountBits));
        // Every passing minimizer before a kept one is kept, and every
        // one of those with occ > 0 before a stored one is stored.
        const int idx = nkb + static_cast<int>((run >> kCountBits) & cmask);
        if (rank <= cap1 && occ[e] > 0 && cumb < lim) {
          ra<G>(kpos, idx) = p0 + e;
          ra<G>(kstart, idx) = start[e];
          ra<G>(kcumb, idx) = static_cast<int>(cumb);
          last_idx = idx;
        }
        if (rank == cap1) S.total = cumb + occ[e];
      }
      run += pk[e];
    }
    last_idx = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(last_idx + 1)));
    if (lane == 0 && last_idx > 0) atomicMax(&S.nkept, last_idx);
    if (next) stage_chunk<NTH>(S.code[(c + 1) & 1], pre);
    const long long n_pass = static_cast<long long>(all & cmask);
    const bool cap_hit = nseen + n_pass >= cap1;
    nseen += n_pass;
    nkb += static_cast<int>((all >> kCountBits) & cmask);
    __syncthreads();
    total = cap_hit ? S.total
                    : total + static_cast<long long>(all >> (2 * kCountBits));
  }
  *total_out = total;
  *nkept_out = S.nkept;
}

// 5. The first crossings in t order, the first n of them to read r's
// output rows, with its count and overflow flag.
template <int NTH, bool G>
__device__ void write_out(const Params& P, int r, int n_t, long long total,
                          const uint8_t* fc, const uint32_t* hitv,
                          const int* toffv, long long* sh) {
  const int n_emit = write_crossings<NTH, G, G>(
      fc, hitv, toffv, n_t, P.max_candidates, P.cand_max,
      P.hits + static_cast<size_t>(r) * P.cand_max, 0xFFFFFFFFll,
      P.offs + static_cast<size_t>(r) * P.cand_max, sh);
  if (threadIdx.x == 0) {
    at(P.counts, r) = min(min(n_emit, P.max_candidates), P.cand_max);
    at(P.overflow, r) = total > P.tup_max ||
                        min(n_emit, P.max_candidates) > P.cand_max;
  }
}

// One read-strand a block, its tuples within kSmemTuples; a read past
// them (when tup_max exceeds the budget) goes to the list defer (count
// at defer[0], the reads after it) for dsoft_large.
template <int INDEX>
__global__ void __launch_bounds__(NTS, 4)
    dsoft_small(Params P, int* defer) {
  constexpr int PPS = CH / NTS;
  __shared__ __align__(16) ScanShared S;
  __shared__ uint32_t s_hit[kSmemTuples];
  __shared__ int s_off[kSmemTuples];
  __shared__ uint8_t s_fc[kSmemTuples];
  // The kept list during the tuples' expansion, the sort's keys after.
  __shared__ __align__(16) int s_kept[3 * kSmemTuples];
  __shared__ unsigned long long s_sorted[kSmemTuples];
  int* kpos = s_kept;
  int* kstart = s_kept + kSmemTuples;
  int* kcumb = s_kept + 2 * kSmemTuples;
  unsigned long long* sk = reinterpret_cast<unsigned long long*>(s_kept);

  const int tid = threadIdx.x, r = blockIdx.x, k = P.k;
  const int ixbase = INDEX == 2 ? at(P.ix.base, 0) : 0;
  const int ixshift = INDEX == 2 ? at(P.ix.shift, 0) : 0;
  const long long lim = min(P.tup_max, kSmemTuples);
  long long total;
  int nkept;
  scan_read<INDEX, NTS, PPS, false>(P, r, lim, ixbase, ixshift, kpos, kstart,
                                    kcumb, S, &total, &nkept);
  if (total > kSmemTuples && P.tup_max > kSmemTuples) {
    if (tid == 0) at(defer, 1 + atomicAdd(&at(defer, 0), 1)) = r;
    return;
  }

  // 3. Tuples t < n_t, ES slots a thread: keys in registers, hit and
  // offset by t in shared memory.  Consecutive slots step through the
  // kept list by at most one entry (each owns one slot or more).
  const int n_t = static_cast<int>(min(total,
                                       static_cast<long long>(P.tup_max)));
  const int i0 = tid * ES;
  int kc = 0;
  if (i0 < n_t) {
    int hi_k = nkept - 1;  // the last kcumb <= i0
    while (kc < hi_k) {
      const int mid = (kc + hi_k + 1) >> 1;
      if (kcumb[mid] <= i0) kc = mid; else hi_k = mid - 1;
    }
  }
  long long src[ES];
  int toff[ES];
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    const int i = i0 + e;
    if (kc + 1 < nkept && kcumb[kc + 1] <= i) ++kc;
    src[e] = static_cast<long long>(kstart[kc]) + i - kcumb[kc];
    toff[e] = kpos[kc];
  }
  unsigned long long x[ES];
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    const int i = i0 + e;
    const uint32_t hit = i < n_t ? at(P.tpos, src[e]) : 0u;
    x[e] = i < n_t ? tuple_key(hit, toff[e], i, P.bin_size) : ~0ull;
    if (i < n_t) {
      s_hit[i] = hit;
      s_off[i] = toff[e];
      s_fc[i] = 0;
    }
  }
  __syncthreads();

  // 4. Sort by (bin, t) in registers, then the per-bin counts and the
  // first crossings over the sorted keys.
  int p2 = 1;
  while (p2 < n_t) p2 <<= 1;
  sort_keys<NTS, ES>(x, p2, sk);
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    if (i0 + e < n_t) s_sorted[i0 + e] = x[e];
  }
  __syncthreads();
  mark_first_crossings<NTS, false, false>(s_sorted, s_hit, s_off, s_fc, n_t, k,
                                   P.threshold, S.sh[0]);
  __syncthreads();
  write_out<NTS, false>(P, r, n_t, total, s_fc, s_hit, s_off, S.sh[1]);
}

// The reads of defer (count at defer[0]), one block of NT threads each,
// the blocks looping over them; a read's arrays by Layout in dynamic
// shared memory (G false) or in a scratch area a block (G true).
template <int INDEX, bool G>
__global__ void __launch_bounds__(NT) dsoft_large(Params P,
                                                  const int* defer) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(16) ScanShared S;

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
  const int k = P.k;
  const int ixbase = INDEX == 2 ? at(P.ix.base, 0) : 0;
  const int ixshift = INDEX == 2 ? at(P.ix.shift, 0) : 0;

  for (int li = blockIdx.x; li < at(defer, 0); li += gridDim.x) {
    const int r = at(defer, 1 + li);
    __syncthreads();  // the previous read's arrays are free
    long long total;
    int nkept;
    scan_read<INDEX, NT, CH / NT, G>(P, r, P.tup_max, ixbase, ixshift,
                                     kpos, kstart, kcumb, S, &total, &nkept);

    // 3. Tuples t < n_t: (bin, t) keys, hit and offset by t.
    const int n_t = static_cast<int>(min(total, static_cast<long long>(
                                                    P.tup_max)));
    for (int t = tid; t < n_t; t += NT) {
      int lo_k = 0, hi_k = nkept - 1;  // the last kcumb <= t
      while (lo_k < hi_k) {
        const int mid = (lo_k + hi_k + 1) >> 1;
        if (ra<G>(kcumb, mid) <= t) lo_k = mid; else hi_k = mid - 1;
      }
      const uint32_t hit = at(P.tpos, static_cast<long long>(
                                          ra<G>(kstart, lo_k)) +
                                          t - ra<G>(kcumb, lo_k));
      const int toff = ra<G>(kpos, lo_k);
      ra<G>(keys, t) = tuple_key(hit, toff, t, P.bin_size);
      ra<G>(hitv, t) = hit;
      ra<G>(toffv, t) = toff;
      ra<G>(fc, t) = 0;
    }
    __syncthreads();

    // 4a. The n_t keys sorted, ascending.
    sort_flip<NT, G>(keys, n_t);

    mark_first_crossings<NT, G, G>(keys, hitv, toffv, fc, n_t, k,
                                P.threshold, S.sh[0]);
    __syncthreads();
    write_out<NT, G>(P, r, n_t, total, fc, hitv, toffv, S.sh[1]);
  }
}

// The large path's blocks: at most one a read, one an SM.
__host__ __device__ constexpr int large_grid(int R, int sms) {
  return R < sms ? R : sms;
}

template <int INDEX>
int launch_mode(const Params& p, int sms, int* defer, cudaStream_t st) {
  if (p.tup_max > kSmemTuples) {
    const cudaError_t e = cudaMemsetAsync(defer, 0, sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dsoft_small<INDEX><<<p.R, NTS, 0, st>>>(p, defer);
  if (p.tup_max <= kSmemTuples) return static_cast<int>(cudaGetLastError());
  const long long bytes = Layout(p.tup_max, p.num_seeds_cap).bytes;
  const int grid = large_grid(p.R, sms);
  if (bytes > kSmemArrays) {
    dsoft_large<INDEX, true><<<grid, NT, 0, st>>>(p, defer);
  } else {
    const auto kernel = dsoft_large<INDEX, false>;
    const int smem = static_cast<int>(bytes);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<grid, NT, smem, st>>>(p, defer);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch bytes a call needs in device memory: 0 when every read
// fits dsoft_small's budget (tup_max <= kSmemTuples); else the list of
// the reads past it (R + 1 ints) and, when dsoft_large's arrays do not
// fit shared memory, a scratch area for each of its blocks.
extern "C" long long dtt_dsoft_scratch_bytes(int R, int tup_max,
                                             int num_seeds_cap, int sms) {
  if (tup_max <= kSmemTuples || R <= 0 || sms < 1) return 0;
  const Layout lay(tup_max, num_seeds_cap);
  return r16(4ll * (R + 1)) +
         (lay.bytes > kSmemArrays ? large_grid(R, sms) * lay.bytes : 0);
}

// index: 0 searchsorted (h = the sorted hashes), 1 dense (csr), 2
// twolevel (h = hd, csr = crs, bkt, base, shift).  sms: the card's SMs;
// scratch: dtt_dsoft_scratch_bytes(R, tup_max, num_seeds_cap, sms)
// bytes, not read when that is 0.
extern "C" int dtt_dsoft(const uint8_t* queries, const int* qlens, int R,
                         int L, const uint32_t* h, const int* csr,
                         const int* bkt, const int* base, const int* shift,
                         int nh, int nb, int steps, const uint32_t* tpos,
                         int k, int w, int bin_size,
                         int kmer_max_occ, int num_seeds_cap, int threshold,
                         int max_candidates, int tup_max, int cand_max,
                         int index, int sms, uint8_t* scratch,
                         long long* hits, int* offs, int* counts,
                         uint8_t* overflow, void* stream) {
  const long long need = dtt_dsoft_scratch_bytes(R, tup_max, num_seeds_cap,
                                                 sms);
  if (R <= 0 || L < 0 || k < 4 || k > kMaxK || w < 1 || w >= k ||
      bin_size < 1 || tup_max < 1 || tup_max >= (1 << 30) ||
      static_cast<long long>(tup_max) * k >= (1ll << 31) || cand_max < 1 ||
      num_seeds_cap < 0 || index < 0 || index > 2 || sms < 1 ||
      (need > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The list of deferred reads first, dsoft_large's scratch areas after.
  int* defer = reinterpret_cast<int*>(scratch);
  Params p{queries, qlens, R, L,
           Index{h, csr, bkt, base, shift, nh, nb, steps},
           tpos, k, w, bin_size, kmer_max_occ, num_seeds_cap, threshold,
           max_candidates, tup_max, cand_max,
           need > 0 ? scratch + r16(4ll * (R + 1)) : nullptr,
           hits, offs, counts, overflow};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  switch (index) {
    case 0: return launch_mode<0>(p, sms, defer, st);
    case 1: return launch_mode<1>(p, sms, defer, st);
    default: return launch_mode<2>(p, sms, defer, st);
  }
}
