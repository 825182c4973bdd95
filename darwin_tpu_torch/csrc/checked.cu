// The checked library's extent table (see checked.cuh); empty in the
// normal build.

#include "checked.cuh"

#ifdef DTT_CHECKED
namespace dtt {
Extents host_extents;
}  // namespace dtt

// The [lo, hi) byte ranges of the next launch's allocations; each C
// entry uploads them to its kernels before it launches.
extern "C" int dtt_set_extents(int n, const unsigned long long* lo,
                               const unsigned long long* hi) {
  if (n < 0 || n > dtt::kMaxExtents) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dtt::host_extents.n = n;
  for (int k = 0; k < n; ++k) {
    dtt::host_extents.lo[k] = lo[k];
    dtt::host_extents.hi[k] = hi[k];
  }
  return 0;
}
#endif
