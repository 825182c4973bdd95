// darwin-tpu native host runtime.
//
// C++ equivalents of the reference's host-side native components, built
// fresh against the same semantics (the Python golden layer is the
// executable spec; parity is enforced by tests/test_native.py):
//
//   * nucleotide coding + w-window minimizer scan
//     (reference ntcoding.cpp:56-182 semantics)
//   * seed-position table build with parallel sort
//     (reference seed_pos_table.cpp:46-98; __gnu_parallel::sort at :71)
//   * multithreaded D-SOFT batch filtration over many reads
//     (reference seed_pos_table.cpp:100-167 per read; threading model
//     from the reference driver darwin.cpp:619-632, which data-
//     parallelizes reads across std::threads)
//   * streaming FASTA loader (reference fasta.cpp:35-98 tolerances,
//     accepting any line wrap like darwin_tpu.io.fasta)
//
// Everything is exposed as a flat C ABI consumed via ctypes
// (darwin_tpu/native/__init__.py).  Buffers that the callee sizes are
// returned through opaque handles with a size/fill/free protocol so the
// Python side can allocate NumPy arrays of exactly the right size.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- coding

// 2-bit code: A=0, C=1, G=2, T=3; N and everything else packs to 0.
// Lowercase packs like uppercase.
inline uint32_t twobit(uint8_t c) {
  switch (c) {
    case 'c': case 'C': return 1;
    case 'g': case 'G': return 2;
    case 't': case 'T': return 3;
    default: return 0;
  }
}

// Thomas Wang 32-bit integer hash masked to 2k bits.
inline uint32_t hash32(uint32_t key, uint32_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

// Pack a sequence into uint32 words, 16 bases each, little-endian
// within the word; `nwords` >= what the scan will touch, zero-padded.
std::vector<uint32_t> pack_words(const uint8_t* seq, int64_t len,
                                 int64_t nwords) {
  std::vector<uint32_t> words(static_cast<size_t>(nwords), 0u);
  for (int64_t i = 0; i < len; ++i) {
    words[static_cast<size_t>(i >> 4)] |= twobit(seq[i]) << (2 * (i & 15));
  }
  return words;
}

inline uint32_t seed_at(const std::vector<uint32_t>& words, int64_t p,
                        uint64_t mask2k) {
  const int64_t idx = p >> 4;
  const uint64_t shift = static_cast<uint64_t>(p & 15);
  const uint64_t concat =
      (static_cast<uint64_t>(words[static_cast<size_t>(idx) + 1]) << 32) |
      words[static_cast<size_t>(idx)];
  return static_cast<uint32_t>((concat >> (2 * shift)) & mask2k);
}

// Hashes of the k-mers at positions [p0, p1) written to out[0..p1-p0).
// The body handles 16 positions (one packed word pair) per iteration
// with straight-line 32-bit ops so the compiler vectorizes both the
// seed extraction (variable 64-bit shifts) and the Wang hash chain —
// the scalar ring-buffer form of this scan ran ~6x slower on AVX2.
void hash_positions(const std::vector<uint32_t>& words, int64_t p0,
                    int64_t p1, uint32_t mask, uint32_t* out) {
  const uint64_t mask64 = mask;
  const int64_t n = p1 - p0;
  int64_t i = 0;
  while (i < n && ((p0 + i) & 15) != 0) {
    out[i] = hash32(seed_at(words, p0 + i, mask64), mask);
    ++i;
  }
  for (; i + 16 <= n; i += 16) {
    const size_t idx = static_cast<size_t>((p0 + i) >> 4);
    const uint64_t concat =
        (static_cast<uint64_t>(words[idx + 1]) << 32) | words[idx];
    uint32_t s[16];
    for (int t = 0; t < 16; ++t)
      s[t] = static_cast<uint32_t>((concat >> (2 * t)) & mask64);
    for (int t = 0; t < 16; ++t) {
      uint32_t key = s[t];
      key = (~key + (key << 21)) & mask;
      key = key ^ (key >> 24);
      key = ((key + (key << 3)) + (key << 8)) & mask;
      key = key ^ (key >> 14);
      key = ((key + (key << 2)) + (key << 4)) & mask;
      key = key ^ (key >> 28);
      key = (key + (key << 31)) & mask;
      out[i + t] = key;
    }
  }
  for (; i < n; ++i)
    out[i] = hash32(seed_at(words, p0 + i, mask64), mask);
}

// Window minima for positions [p0, p0+n): wmin[i] = min of the hashes
// at positions p0+i-w+1 .. p0+i (the w-window ending at p0+i, exactly
// the ring-buffer semantics).  h must hold n + w - 1 entries.
void wmin_chunk(const std::vector<uint32_t>& words, uint32_t mask, int w,
                int64_t p0, int64_t n, uint32_t* h, uint32_t* wmin) {
  hash_positions(words, p0 - w + 1, p0 + n, mask, h);
  for (int64_t i = 0; i < n; ++i) wmin[i] = h[i];
  for (int d = 1; d < w; ++d)
    for (int64_t i = 0; i < n; ++i)
      wmin[i] = std::min(wmin[i], h[i + d]);
}

// Stable LSD radix sort of (hash << 32) | pos keys on the 2k hash bits.
// Scan order already has positions ascending, so two stable counting
// passes on the hash give the fully sorted order the reference's
// __gnu_parallel::sort produces (seed_pos_table.cpp:71) in O(n) — the
// comparison sort was the build's second-largest term at 250 Mb.
void sort_keys_by_hash(std::vector<uint64_t>* v, int k) {
  const size_t n = v->size();
  if (n < 2) return;
  const int bits = 2 * k;
  const int b1 = bits / 2;
  const int b2 = bits - b1;
  std::vector<uint64_t> tmp(n);
  {
    const uint32_t m1 = (1u << b1) - 1;
    std::vector<uint32_t> cnt((size_t{1} << b1) + 1, 0);
    for (size_t i = 0; i < n; ++i)
      ++cnt[(static_cast<uint32_t>((*v)[i] >> 32) & m1) + 1];
    for (size_t b = 1; b < cnt.size(); ++b) cnt[b] += cnt[b - 1];
    for (size_t i = 0; i < n; ++i)
      tmp[cnt[static_cast<uint32_t>((*v)[i] >> 32) & m1]++] = (*v)[i];
  }
  {
    const uint32_t m2 = (1u << b2) - 1;
    std::vector<uint32_t> cnt((size_t{1} << b2) + 1, 0);
    for (size_t i = 0; i < n; ++i)
      ++cnt[(static_cast<uint32_t>(tmp[i] >> (32 + b1)) & m2) + 1];
    for (size_t b = 1; b < cnt.size(); ++b) cnt[b] += cnt[b - 1];
    for (size_t i = 0; i < n; ++i)
      (*v)[cnt[static_cast<uint32_t>(tmp[i] >> (32 + b1)) & m2]++] = tmp[i];
  }
}

// w-window minimizer scan.  `query_conv` selects the word-count
// convention: reference genome uses s_len = 1 + len/16, queries use
// ceil(len/16) — the scan range 16*s_len - k - w deliberately covers
// zero-padding at the tail, exactly like the reference.
//
// Sequential emit rule: emit (p, m) whenever the window minimum differs
// from the last emitted minimum or the window advanced >= w positions
// since the last emission (last_m = last_p = 0 initially).
void minimizer_scan(const uint8_t* seq, int64_t len, int k, int w,
                    bool query_conv, std::vector<uint64_t>* out_pm) {
  const int64_t s_len = query_conv ? (len + 15) / 16 : 1 + len / 16;
  const int64_t hi = 16 * s_len - k - w;
  const int64_t lo = w - 1;
  if (hi <= lo) return;

  const std::vector<uint32_t> words = pack_words(seq, len, s_len + 1);
  const uint32_t mask = static_cast<uint32_t>((1ull << (2 * k)) - 1);

  // Chunked: vectorized hash + window-min arrays, then the (cheap)
  // sequential emit rule — emit when the window minimum differs from
  // the last emitted one or the window advanced >= w positions since
  // the last emission (last_m = last_p = 0 initially).
  constexpr int64_t C = 8192;
  std::vector<uint32_t> h(static_cast<size_t>(C + w + 15));
  std::vector<uint32_t> wmin(static_cast<size_t>(C));
  uint32_t last_m = 0;
  int64_t last_p = 0;
  for (int64_t p0 = lo; p0 < hi; p0 += C) {
    const int64_t n = std::min(C, hi - p0);
    wmin_chunk(words, mask, w, p0, n, h.data(), wmin.data());
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t m = wmin[static_cast<size_t>(i)];
      const int64_t p = p0 + i;
      if (m != last_m || p - last_p >= w) {
        out_pm->push_back((static_cast<uint64_t>(m) << 32) |
                          static_cast<uint64_t>(p));
        last_m = m;
        last_p = p;
      }
    }
  }
}

struct U64Buf {
  std::vector<uint64_t> v;
};

}  // namespace

extern "C" {

int dt_version() { return 1; }

// ---- generic uint64 buffer protocol ----------------------------------

int64_t dt_buf_size(void* h) {
  return static_cast<int64_t>(static_cast<U64Buf*>(h)->v.size());
}

void dt_buf_fill(void* h, uint64_t* dst) {
  const auto& v = static_cast<U64Buf*>(h)->v;
  std::memcpy(dst, v.data(), v.size() * sizeof(uint64_t));
}

void dt_buf_free(void* h) { delete static_cast<U64Buf*>(h); }

// ---- minimizer scan ---------------------------------------------------

// Returns a U64Buf of (hash << 32) | pos in scan order.
void* dt_scan_minimizers(const uint8_t* seq, int64_t len, int k, int w,
                         int query_conv) {
  auto* buf = new U64Buf();
  minimizer_scan(seq, len, k, w, query_conv != 0, &buf->v);
  return buf;
}

// Seed-table build: reference-convention scan + parallel sort of the
// (hash << 32) | pos keys (sort by hash, then position).
//
// The scan itself is parallelized EXACTLY: the sequential emit rule
// ("emit when the window min changes or w positions passed since the
// last emission") factors into (a) change points, which depend only on
// a w-window of hashes and are found in parallel chunks, and (b)
// within each inter-change run [c, c') anchored at its change point
// (the run before the first change is anchored at the virtual p=0),
// emissions at c, c+w, c+2w, ... < c' — independent per run.
void* dt_build_table(const uint8_t* ref, int64_t len, int k, int w,
                     int nthreads) {
  auto* buf = new U64Buf();
  const int64_t s_len = 1 + len / 16;
  const int64_t hi = 16 * s_len - k - w;
  const int64_t lo = w - 1;
  if (hi <= lo) return buf;
  if (nthreads <= 1 || hi - lo < 1 << 16) {
    minimizer_scan(ref, len, k, w, false, &buf->v);
  } else {
    const std::vector<uint32_t> words = pack_words(ref, len, s_len + 1);
    const uint32_t mask = static_cast<uint32_t>((1ull << (2 * k)) - 1);
    const uint64_t mask64 = mask;
    auto win_min = [&](int64_t p) {
      uint32_t m = hash32(seed_at(words, p - w + 1, mask64), mask);
      for (int i = 1; i < w; ++i)
        m = std::min(m, hash32(seed_at(words, p - w + 1 + i, mask64),
                               mask));
      return m;
    };

    // Pass A: change points, in parallel chunks (virtual change at lo
    // when m(lo) != 0, matching last_m = 0 initially).  Window minima
    // come from the vectorized chunk kernel.
    const int nt = nthreads;
    std::vector<std::vector<int64_t>> changes(
        static_cast<size_t>(nt));
    {
      std::vector<std::thread> ths;
      const int64_t span = (hi - lo + nt - 1) / nt;
      for (int t = 0; t < nt; ++t) {
        ths.emplace_back([&, t]() {
          const int64_t a = lo + t * span;
          const int64_t b = std::min(hi, a + span);
          auto& out = changes[static_cast<size_t>(t)];
          constexpr int64_t C = 8192;
          std::vector<uint32_t> h(static_cast<size_t>(C + w + 15));
          std::vector<uint32_t> wmin(static_cast<size_t>(C));
          uint32_t prev = (a == lo) ? 0 : win_min(a - 1);
          for (int64_t p0 = a; p0 < b; p0 += C) {
            const int64_t n = std::min(C, b - p0);
            wmin_chunk(words, mask, w, p0, n, h.data(), wmin.data());
            for (int64_t i = 0; i < n; ++i) {
              const uint32_t m = wmin[static_cast<size_t>(i)];
              if (m != prev) out.push_back(p0 + i);
              prev = m;
            }
          }
        });
      }
      for (auto& th : ths) th.join();
    }
    std::vector<int64_t> cps;
    cps.push_back(0);  // virtual anchor (emits at multiples of w > 0)
    for (auto& c : changes) cps.insert(cps.end(), c.begin(), c.end());
    cps.push_back(hi);

    // Pass B: per-run emissions, parallel over contiguous run blocks —
    // contiguous (not strided) so the concatenated output keeps scan
    // (position) order within every hash, which the stable radix sort
    // below relies on.
    std::vector<std::vector<uint64_t>> outs(static_cast<size_t>(nt));
    {
      std::vector<std::thread> ths;
      const size_t nruns = cps.size() - 1;
      const size_t per_t = (nruns + static_cast<size_t>(nt) - 1) /
                           static_cast<size_t>(nt);
      for (int t = 0; t < nt; ++t) {
        ths.emplace_back([&, t]() {
          auto& out = outs[static_cast<size_t>(t)];
          const size_t r0 = static_cast<size_t>(t) * per_t;
          const size_t r1 = std::min(nruns, r0 + per_t);
          for (size_t i = r0; i < r1; ++i) {
            const int64_t c = cps[i];
            const int64_t next_c = cps[i + 1];
            // First emission of the run: the change point itself, or
            // for the virtual run (min == 0 since the start) position w
            // exactly: the sequential scan's last_p starts at 0, so its
            // first zero-hash emission is at p - 0 >= w.  (Not p=0 even
            // when w == 1 and hash(seed at 0) == 0.)
            int64_t p0 = (i == 0) ? w : c;
            for (int64_t p = p0; p < next_c; p += w) {
              if (p < lo) continue;
              out.push_back((static_cast<uint64_t>(win_min(p)) << 32) |
                            static_cast<uint64_t>(p));
            }
          }
        });
      }
      for (auto& th : ths) th.join();
    }
    size_t total = 0;
    for (auto& o : outs) total += o.size();
    buf->v.reserve(total);
    for (auto& o : outs) buf->v.insert(buf->v.end(), o.begin(), o.end());
  }
  sort_keys_by_hash(&buf->v, k);
  return buf;
}

// ---- D-SOFT batch -----------------------------------------------------

struct DtDsoft {
  // Per-read candidate lists, concatenated lazily on fill.
  std::vector<std::vector<uint64_t>> hits;     // per read
  std::vector<std::vector<uint64_t>> offsets;  // per read
};

// Multithreaded D-SOFT over a batch of reads.  Reads are data-parallel
// across threads (like the reference's per-thread AlignReads split);
// each thread owns dense bin-state arrays reset via a touched-bin list
// after every read (the reference's nz_bins_array reset idiom,
// seed_pos_table.cpp:150-163).
//
// Per-read loop semantics (the executable spec is
// darwin_tpu/golden/dsoft.py::dsoft_scalar):
//   * skip minimizers whose hash occurs more than kmer_max_occ times
//   * process at most the first num_seeds_cap+1 passing minimizers
//   * per hit with hit >= offset: bin = (hit-offset)/bin_size;
//     a bin below threshold adds k for a fresh/non-overlapping seed
//     else offset-delta; one candidate at the first threshold crossing
//   * max_candidates truncates emissions; the crossing that hits the
//     cap breaks only the current minimizer's hit loop
void* dt_dsoft_batch(const uint32_t* hashes, const uint32_t* pos,
                     int64_t table_n, int k, int64_t bin_size,
                     int64_t ref_size, int64_t kmer_max_occ, int w,
                     const uint8_t* flat, const int64_t* starts,
                     const int64_t* lens, const int64_t* read_ids,
                     int64_t nreads, int64_t num_seeds_cap,
                     int64_t threshold, int64_t max_candidates,
                     int nthreads) {
  auto* res = new DtDsoft();
  res->hits.resize(static_cast<size_t>(nreads));
  res->offsets.resize(static_cast<size_t>(nreads));
  if (nreads == 0) return res;

  const int64_t num_bins = ref_size / bin_size + 2;
  nthreads = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(nthreads, nreads)));

  // Two-level index: a dense prefix array narrows each hash lookup to
  // one bucket (the memory-bounded form of the reference's dense
  // index_table, seed_pos_table.cpp:73-94).  PB prefix bits cap the
  // array at 4M entries; binary search finishes within the bucket.
  const int pb = std::min(2 * k, 22);
  const int shift = 2 * k - pb;
  const size_t nbuckets = size_t{1} << pb;
  std::vector<uint32_t> prefix(nbuckets + 1, 0);
  for (int64_t i = 0; i < table_n; ++i)
    ++prefix[(hashes[i] >> shift) + 1];
  for (size_t b = 1; b <= nbuckets; ++b) prefix[b] += prefix[b - 1];

  auto worker = [&](int tid) {
    std::vector<int64_t> count(static_cast<size_t>(num_bins), 0);
    std::vector<int64_t> last_off(static_cast<size_t>(num_bins), 0);
    std::vector<int64_t> touched;
    std::vector<uint64_t> mins;

    for (int64_t r = tid; r < nreads; r += nthreads) {
      const int64_t rid = read_ids ? read_ids[r] : r;
      const uint8_t* seq = flat + starts[rid];
      const int64_t len = lens[rid];
      mins.clear();
      minimizer_scan(seq, len, k, w, true, &mins);

      auto& out_h = res->hits[static_cast<size_t>(r)];
      auto& out_o = res->offsets[static_cast<size_t>(r)];
      int64_t num_seeds = 0;
      for (const uint64_t pm : mins) {
        const uint32_t h = static_cast<uint32_t>(pm >> 32);
        const int64_t offset = static_cast<int64_t>(pm & 0xFFFFFFFFu);
        const uint32_t* bkt_lo = hashes + prefix[h >> shift];
        const uint32_t* bkt_up = hashes + prefix[(h >> shift) + 1];
        const uint32_t* lo = std::lower_bound(bkt_lo, bkt_up, h);
        const uint32_t* up = std::upper_bound(lo, bkt_up, h);
        if (up - lo > kmer_max_occ) continue;
        if (num_seeds > num_seeds_cap) break;
        ++num_seeds;
        for (const uint32_t* it = lo; it != up; ++it) {
          const int64_t hit = static_cast<int64_t>(pos[it - hashes]);
          if (hit < offset) continue;
          const int64_t b = (hit - offset) / bin_size;
          const int64_t curr = count[static_cast<size_t>(b)];
          if (curr >= threshold) continue;
          if (curr == 0) touched.push_back(b);
          const int64_t delta = offset - last_off[static_cast<size_t>(b)];
          const int64_t nc =
              (delta > k || curr == 0) ? curr + k : curr + delta;
          count[static_cast<size_t>(b)] = nc;
          last_off[static_cast<size_t>(b)] = offset;
          if (nc >= threshold) {
            if (static_cast<int64_t>(out_h.size()) >= max_candidates) break;
            out_h.push_back(static_cast<uint64_t>(hit));
            out_o.push_back(static_cast<uint64_t>(offset));
          }
        }
      }
      for (const int64_t b : touched) {
        count[static_cast<size_t>(b)] = 0;
        last_off[static_cast<size_t>(b)] = 0;
      }
      touched.clear();
    }
  };

  if (nthreads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(nthreads));
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  return res;
}

int64_t dt_dsoft_total(void* h) {
  const auto* res = static_cast<DtDsoft*>(h);
  int64_t total = 0;
  for (const auto& v : res->hits) total += static_cast<int64_t>(v.size());
  return total;
}

// Concatenates per-read results in read order; `counts` gets the
// per-read candidate counts (length nreads).
void dt_dsoft_fill(void* h, int64_t* counts, int64_t* hits,
                   int64_t* offsets) {
  const auto* res = static_cast<DtDsoft*>(h);
  int64_t at = 0;
  for (size_t r = 0; r < res->hits.size(); ++r) {
    const auto& hv = res->hits[r];
    const auto& ov = res->offsets[r];
    counts[r] = static_cast<int64_t>(hv.size());
    for (size_t i = 0; i < hv.size(); ++i) {
      hits[at] = static_cast<int64_t>(hv[i]);
      offsets[at] = static_cast<int64_t>(ov[i]);
      ++at;
    }
  }
}

void dt_dsoft_free(void* h) { delete static_cast<DtDsoft*>(h); }

// ---- FASTA loader -----------------------------------------------------

struct DtFasta {
  std::string seq_blob;
  std::vector<int64_t> seq_offsets;   // nrecords + 1
  std::string desc_blob;              // description lines incl. '>'
  std::vector<int64_t> desc_offsets;  // nrecords + 1
  bool ok = false;
};

// Streaming parse; blank lines skipped, trailing CR stripped, any
// sequence-line wrapping accepted.  Returns nullptr only on allocation
// failure; parse/IO errors set ok=false and the Python side falls back
// to the pure parser (which raises the detailed error).
void* dt_fasta_parse(const char* path) {
  auto* f = new DtFasta();
  std::ifstream in(path, std::ios::binary);
  if (!in) return f;
  f->seq_offsets.push_back(0);
  f->desc_offsets.push_back(0);
  std::string line;
  bool have_record = false;
  while (std::getline(in, line)) {
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    if (line.empty()) continue;
    if (line[0] == '>') {
      if (have_record)
        f->seq_offsets.push_back(static_cast<int64_t>(f->seq_blob.size()));
      f->desc_blob += line;
      f->desc_offsets.push_back(static_cast<int64_t>(f->desc_blob.size()));
      have_record = true;
    } else {
      if (!have_record) return f;  // ok=false: starts with sequence data
      f->seq_blob += line;
    }
  }
  if (have_record)
    f->seq_offsets.push_back(static_cast<int64_t>(f->seq_blob.size()));
  f->ok = true;
  return f;
}

int dt_fasta_ok(void* h) { return static_cast<DtFasta*>(h)->ok ? 1 : 0; }

int64_t dt_fasta_nrecords(void* h) {
  return static_cast<int64_t>(static_cast<DtFasta*>(h)->desc_offsets.size()) -
         1;
}

int64_t dt_fasta_seq_total(void* h) {
  return static_cast<int64_t>(static_cast<DtFasta*>(h)->seq_blob.size());
}

int64_t dt_fasta_desc_total(void* h) {
  return static_cast<int64_t>(static_cast<DtFasta*>(h)->desc_blob.size());
}

void dt_fasta_fill(void* h, uint8_t* seq_blob, int64_t* seq_offsets,
                   uint8_t* desc_blob, int64_t* desc_offsets) {
  const auto* f = static_cast<DtFasta*>(h);
  std::memcpy(seq_blob, f->seq_blob.data(), f->seq_blob.size());
  std::memcpy(seq_offsets, f->seq_offsets.data(),
              f->seq_offsets.size() * sizeof(int64_t));
  std::memcpy(desc_blob, f->desc_blob.data(), f->desc_blob.size());
  std::memcpy(desc_offsets, f->desc_offsets.data(),
              f->desc_offsets.size() * sizeof(int64_t));
}

void dt_fasta_free(void* h) { delete static_cast<DtFasta*>(h); }

}  // extern "C"
