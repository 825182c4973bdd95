// Tile span fetch for Hopper (sm_90a).
//
// Replaces: darwin_tpu/ops/tile_fetch.py, fetch_tiles (the pallas_call
// at line 161), plus the length masks the JAX engine applies after it
// (engine/device_batch.py:343-346).
//
// What it computes, for each of one or two span sets (bank, n, start,
// len, pad, out) that share one backward flag a slot: out[b, k] for
// k < T.  For k < len[b] it is the bank byte start[b] + k (a forward
// read: the engine's reverse-phase tiles, [pos-len, pos)) or
// start[b] + len[b] - 1 - k (a backward read: the forward-phase tiles,
// [pos, pos+len) back to front, device_batch.py:320-322); for
// k >= len[b] it is the pad byte.  Bank offsets are int64 and clipped
// into [0, n-1].  The engine fetches its ref and query tiles of an
// iteration as the two sets of one launch.
//
// What the TPU design needed and this one does not: the TPU kernel
// reads a [groups, 4, 512] bank holding a reversed copy of the
// sequences (Mosaic has no backward read, and u8 arrays tile by 4
// rows), addressed by int32 (row, byte) pairs.  Here the bank is the
// flat forward bytes, addressed by int64: half the device memory, no
// split-address arithmetic.
//
// What bounds it on the H100: launch latency.  At B = 512, T = 320 a
// set moves 164 KB in and 164 KB out, well under a microsecond of HBM
// time.
//
// Design: one thread per 16 output bytes, grid.y the span set.  A chunk
// that lies inside the row, inside len and inside the bank reads its 16
// bank bytes as one or two aligned 16-byte loads and a funnel shift, and
// reverses them with __byte_perm for a backward span; the chunks that
// cross len, clip at 0 or n-1 or hold a row's tail (T % 16 != 0) go
// byte by byte.  Aligned loads may touch bytes past n-1 up to n_read,
// the bytes readable from the bank's first byte (device_banks pads each
// bank to a multiple of 16).  Stores are 16-byte where the output chunk
// is 16-byte aligned, else 8-, 4- or 1-byte.

#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

using dtt::at;

constexpr int THREADS = 128;

struct SpanSet {
  const uint8_t* bank;
  long long n;       // logical length: offsets clip into [0, n-1]
  long long n_read;  // bytes readable from bank[0] by aligned loads
  const long long* start;
  const int* len;
  uint8_t* out;
  int pad;
};

// bank[lo .. lo+15] from the aligned 16-byte blocks that cover them.
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned o = a & 15;
  const uint4* q = reinterpret_cast<const uint4*>(a - o);
  const uint4 lo = __ldg(&at(q, 0));
  if (o == 0) return lo;
  const uint4 hi = __ldg(&at(q, 1));
  uint32_t w0 = lo.x, w1 = lo.y, w2 = lo.z, w3 = lo.w;
  uint32_t w4 = hi.x, w5 = hi.y, w6 = hi.z, w7 = hi.w;
  if (o & 8) {
    w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; w5 = w7;
  }
  if (o & 4) {
    w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5;
  }
  const unsigned sh = (o & 3) * 8;
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// The 16 bytes in reverse order.
__device__ __forceinline__ uint4 reverse16(uint4 v) {
  return make_uint4(__byte_perm(v.w, 0, 0x0123), __byte_perm(v.z, 0, 0x0123),
                    __byte_perm(v.y, 0, 0x0123), __byte_perm(v.x, 0, 0x0123));
}

// The first nb bytes of v to dst, as wide as dst's alignment allows.
__device__ __forceinline__ void store(uint8_t* dst, uint4 v, int nb) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (nb == 16) {
    if ((a & 15) == 0) {
      at(reinterpret_cast<uint4*>(dst), 0) = v;
      return;
    }
    if ((a & 7) == 0) {
      at(reinterpret_cast<uint2*>(dst), 0) = make_uint2(v.x, v.y);
      at(reinterpret_cast<uint2*>(dst), 1) = make_uint2(v.z, v.w);
      return;
    }
    if ((a & 3) == 0) {
      uint32_t* w = reinterpret_cast<uint32_t*>(dst);
      at(w, 0) = v.x; at(w, 1) = v.y; at(w, 2) = v.z; at(w, 3) = v.w;
      return;
    }
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int t = 0; t < 16; ++t)
    if (t < nb) at(dst, t) = static_cast<uint8_t>(w[t / 4] >> (8 * (t % 4)));
}

// Field by field, so that the choice compiles to selects and the
// kernel's parameters are not copied to local memory.
__device__ __forceinline__ SpanSet pick(const SpanSet& a, const SpanSet& b,
                                        bool second) {
  return SpanSet{second ? b.bank : a.bank,   second ? b.n : a.n,
                 second ? b.n_read : a.n_read, second ? b.start : a.start,
                 second ? b.len : a.len,     second ? b.out : a.out,
                 second ? b.pad : a.pad};
}

__global__ void __launch_bounds__(THREADS) fetch_tiles_kernel(
    SpanSet set0, SpanSet set1, const uint8_t* __restrict__ backward, int B,
    int T) {
  const SpanSet sp = pick(set0, set1, blockIdx.y != 0);
  const int chunks = (T + 15) / 16;
  const int g = blockIdx.x * THREADS + threadIdx.x;  // B * chunks < 2^31
  if (g >= B * chunks) return;
  const int b = g / chunks;
  const int k0 = (g - b * chunks) * 16;
  const int nb = min(16, T - k0);  // bytes of the chunk inside the row
  const int L = at(sp.len, b);
  const long long s = at(sp.start, b);
  const bool back = at(backward, b) != 0;

  // The chunk's bank bytes in bank order start at lo.
  const long long lo = back ? s + L - 16 - k0 : s + k0;
  const uintptr_t base = reinterpret_cast<uintptr_t>(sp.bank);
  uint4 v;
  if (nb == 16 && k0 + 16 <= L && lo >= 0 && lo + 16 <= sp.n &&
      ((base + lo) & ~uintptr_t{15}) >= base &&
      (((base + lo + 15) | 15) + 1) - base <=
          static_cast<uintptr_t>(sp.n_read)) {
    v = load16(sp.bank + lo);
    if (back) v = reverse16(v);
  } else {
    const uint32_t pad = static_cast<uint32_t>(sp.pad) * 0x01010101u;
    v = make_uint4(pad, pad, pad, pad);
    if (k0 < L) {
      // Offsets clamped into the bank, so every load is safe and none
      // is conditional: all 16 are in flight together.
      uint32_t byte[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        long long idx = back ? s + L - 1 - k0 - t : s + k0 + t;
        idx = idx < 0 ? 0 : (idx >= sp.n ? sp.n - 1 : idx);
        byte[t] = at(sp.bank, idx);
      }
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int t = 0; t < 16; ++t)
        w[t / 4] |= (k0 + t < L ? byte[t] : sp.pad & 0xFF) << (8 * (t % 4));
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  store(sp.out + static_cast<size_t>(b) * T + k0, v, nb);
}

}  // namespace

// nsets 1 or 2; the second set's arguments are ignored when nsets is 1.
extern "C" int dtt_fetch_tiles(
    int nsets, const uint8_t* bank0, long long n0, long long n_read0,
    const long long* start0, const int* len0, int pad0, uint8_t* out0,
    const uint8_t* bank1, long long n1, long long n_read1,
    const long long* start1, const int* len1, int pad1, uint8_t* out1,
    const uint8_t* backward, int B, int T, void* stream) {
  const SpanSet set0{bank0, n0, n_read0, start0, len0, out0, pad0};
  const SpanSet set1{bank1, n1, n_read1, start1, len1, out1, pad1};
  const int threads = B * ((T + 15) / 16);
  const dim3 grid((threads + THREADS - 1) / THREADS, nsets);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  fetch_tiles_kernel<<<grid, THREADS, 0, st>>>(set0, set1, backward, B, T);
  return static_cast<int>(cudaGetLastError());
}
