// Global memory accesses of the kernels, plain or range-checked.
//
// Every global load and store of the kernels in csrc/ goes through
// dtt::at(p, i), which is p[i].  Built with -DDTT_CHECKED (the checked library, _build.py
// build(checked=True)), at() first finds the allocation that holds p
// among the extents the wrapper passed in (dtt_set_extents: each tensor
// argument's whole storage, not its logical length, since the span
// fetch's aligned loads may read into a bank's padding and the DP writes
// word rows past rlen) and calls __trap() unless p + i lies inside that
// allocation with all its sizeof(T) bytes.  A trap ends the CUDA
// context, so the checked library is run in a process of its own
// (chip_smoke.py --checked).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace dtt {

#ifdef DTT_CHECKED
constexpr int kMaxExtents = 32;
// [lo, hi) byte ranges of the launch's allocations.
struct Extents {
  int n;
  unsigned long long lo[kMaxExtents];
  unsigned long long hi[kMaxExtents];
};
// The extents of the next launch, set by dtt_set_extents (checked.cu).
extern Extents host_extents;
// Each translation unit's own device copy, uploaded by
// DTT_UPLOAD_EXTENTS before each of its launches.
static __constant__ Extents g_extents;

__device__ __forceinline__ void check(const void* p, ptrdiff_t i,
                                      size_t bytes) {
  const auto base = reinterpret_cast<unsigned long long>(p);
  const unsigned long long a = base + i * static_cast<long long>(bytes);
  for (int k = 0; k < g_extents.n; ++k) {
    if (base >= g_extents.lo[k] && base < g_extents.hi[k]) {
      if (a >= g_extents.lo[k] && a + bytes <= g_extents.hi[k]) return;
      break;
    }
  }
  __trap();
}

#define DTT_UPLOAD_EXTENTS(stream)                                        \
  do {                                                                    \
    const cudaError_t e_ = cudaMemcpyToSymbolAsync(                       \
        dtt::g_extents, &dtt::host_extents, sizeof(dtt::Extents), 0,      \
        cudaMemcpyHostToDevice, stream);                                  \
    if (e_ != cudaSuccess) return static_cast<int>(e_);                   \
  } while (0)
#else
#define DTT_UPLOAD_EXTENTS(stream) \
  do {                             \
  } while (0)
#endif

// p[i], checked in the checked library.
template <typename T>
__device__ __forceinline__ T& at(T* p, ptrdiff_t i) {
#ifdef DTT_CHECKED
  check(p, i, sizeof(T));
#endif
  return p[i];
}

}  // namespace dtt
