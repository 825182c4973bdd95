// Tile span fetch for Hopper (sm_90a).
//
// Replaces: darwin_tpu/ops/tile_fetch.py, fetch_tiles (the pallas_call
// at line 161), plus the length masks the JAX engine applies after it
// (engine/device_batch.py:343-346).
//
// What it computes: out[b, k] for k < T.  For k < len[b] it is the bank
// byte start[b] + k (a forward read: the engine's reverse-phase tiles,
// [pos-len, pos)) or start[b] + len[b] - 1 - k (a backward read: the
// forward-phase tiles, [pos, pos+len) back to front,
// device_batch.py:320-322); for k >= len[b] it is the pad byte.  Bank
// offsets are int64 and clipped into the bank.
//
// What the TPU design needed and this one does not: the TPU kernel
// reads a [groups, 4, 512] bank holding a reversed copy of the
// sequences (Mosaic has no backward read, and u8 arrays tile by 4
// rows), addressed by int32 (row, byte) pairs.  Here the bank is the
// flat forward bytes, addressed by int64: half the device memory, no
// split-address arithmetic.
//
// What bounds it on the H100: launch latency.  At B = 512, T = 320 it
// moves 164 KB in and 164 KB out, well under a microsecond of HBM time.
//
// Design: one block per tile, one thread per output byte; neighbouring
// threads read neighbouring bank bytes (ascending or descending), so a
// warp's loads fall in one or two 32-byte sectors either way.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void fetch_tiles_kernel(const uint8_t* __restrict__ bank,
                                   long long n,
                                   const long long* __restrict__ start,
                                   const int* __restrict__ len,
                                   const uint8_t* __restrict__ backward,
                                   int T, int pad,
                                   uint8_t* __restrict__ out) {
  const int b = blockIdx.x;
  const int L = len[b];
  const long long s = start[b];
  const bool back = backward[b] != 0;
  uint8_t* out_b = out + static_cast<size_t>(b) * T;
  for (int k = threadIdx.x; k < T; k += blockDim.x) {
    uint8_t v = static_cast<uint8_t>(pad);
    if (k < L) {
      long long idx = back ? s + L - 1 - k : s + k;
      idx = idx < 0 ? 0 : (idx >= n ? n - 1 : idx);
      v = bank[idx];
    }
    out_b[k] = v;
  }
}

}  // namespace

extern "C" int dtt_fetch_tiles(const uint8_t* bank, long long n,
                               const long long* start, const int* len,
                               const uint8_t* backward, int B, int T,
                               int pad, uint8_t* out, void* stream) {
  const int threads = T < 1024 ? (T + 31) / 32 * 32 : 1024;
  fetch_tiles_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      bank, n, start, len, backward, T, pad, out);
  return static_cast<int>(cudaGetLastError());
}
