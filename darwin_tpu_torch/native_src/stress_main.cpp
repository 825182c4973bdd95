// Concurrency stress driver for the native host runtime.
//
// Built by `make -C darwin_tpu/native tsan` (ThreadSanitizer) or
// `make stress` (plain).  Exercises the two multithreaded components
// — the parallel seed-table build (change-point scan + parallel sort)
// and the read-parallel D-SOFT batch — across thread counts, checking
// that every configuration produces identical results, while tsan
// watches for data races.  Exit 0 = deterministic and race-free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int dt_version();
int64_t dt_buf_size(void*);
void dt_buf_fill(void*, uint64_t*);
void dt_buf_free(void*);
void* dt_build_table(const uint8_t*, int64_t, int, int, int);
void* dt_dsoft_batch(const uint32_t*, const uint32_t*, int64_t, int,
                     int64_t, int64_t, int64_t, int, const uint8_t*,
                     const int64_t*, const int64_t*, const int64_t*,
                     int64_t, int64_t, int64_t, int64_t, int);
int64_t dt_dsoft_total(void*);
void dt_dsoft_fill(void*, int64_t*, int64_t*, int64_t*);
void dt_dsoft_free(void*);
}

static uint64_t rng_state = 0x9e3779b97f4a7c15ull;
static uint32_t rnd() {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return static_cast<uint32_t>(rng_state >> 32);
}

static std::vector<uint64_t> take(void* h) {
  std::vector<uint64_t> v(static_cast<size_t>(dt_buf_size(h)));
  if (!v.empty()) dt_buf_fill(h, v.data());
  dt_buf_free(h);
  return v;
}

int main() {
  if (dt_version() != 1) {
    std::fprintf(stderr, "version mismatch\n");
    return 2;
  }
  const char bases[] = "ACGT";
  const int64_t ref_len = 400000;
  std::vector<uint8_t> ref(ref_len);
  for (auto& c : ref) c = static_cast<uint8_t>(bases[rnd() & 3]);

  // 1. Table build determinism across thread counts (incl. w=1).
  for (int w : {1, 3, 4}) {
    const int k = 13;
    std::vector<uint64_t> base;
    for (int nt : {1, 2, 5, 8, 16}) {
      auto keys = take(dt_build_table(ref.data(), ref_len, k, w, nt));
      if (nt == 1) {
        base = keys;
      } else if (keys != base) {
        std::fprintf(stderr, "table mismatch w=%d nt=%d\n", w, nt);
        return 1;
      }
    }
    std::printf("table build w=%d: %zu keys, deterministic\n", w,
                base.size());
  }

  // 2. D-SOFT batch determinism across thread counts.
  const int k = 13, w = 4;
  auto keys = take(dt_build_table(ref.data(), ref_len, k, w, 8));
  std::vector<uint32_t> hashes(keys.size()), pos(keys.size());
  for (size_t i = 0; i < keys.size(); ++i) {
    hashes[i] = static_cast<uint32_t>(keys[i] >> 32);
    pos[i] = static_cast<uint32_t>(keys[i]);
  }
  const int64_t nreads = 64;
  std::vector<uint8_t> flat;
  std::vector<int64_t> starts, lens, ids;
  for (int64_t r = 0; r < nreads; ++r) {
    const int64_t len = 1500 + (rnd() % 3000);
    const int64_t s0 = rnd() % (ref_len - len);
    starts.push_back(static_cast<int64_t>(flat.size()));
    lens.push_back(len);
    ids.push_back(r);
    for (int64_t i = 0; i < len; ++i) {
      uint8_t c = ref[s0 + i];
      if ((rnd() & 15) == 0) c = static_cast<uint8_t>(bases[rnd() & 3]);
      flat.push_back(c);
    }
  }
  std::vector<int64_t> bc, bh, bo;
  for (int nt : {1, 3, 8, 16}) {
    void* h = dt_dsoft_batch(hashes.data(), pos.data(),
                             static_cast<int64_t>(hashes.size()), k, 64,
                             ref_len, 200, w, flat.data(), starts.data(),
                             lens.data(), ids.data(), nreads, 800, 21,
                             1000000, nt);
    std::vector<int64_t> c(nreads), hh(dt_dsoft_total(h)),
        oo(dt_dsoft_total(h));
    dt_dsoft_fill(h, c.data(), hh.data(), oo.data());
    dt_dsoft_free(h);
    if (nt == 1) {
      bc = c; bh = hh; bo = oo;
    } else if (c != bc || hh != bh || oo != bo) {
      std::fprintf(stderr, "dsoft mismatch nt=%d\n", nt);
      return 1;
    }
  }
  std::printf("dsoft batch: %zu candidates, deterministic\n", bh.size());
  std::printf("STRESS OK\n");
  return 0;
}
