// Definitions the tile DP's two sources share (csrc/dp.cu, the
// one-warp and int32 split paths; csrc/dp16.cu, the 16-bit split path):
// the launch arguments, the output formats and the direction-ring
// geometry.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

using dtt::at;

constexpr int NEG_INF = 1 << 30;
constexpr int GAP_OPEN_FLAG_I = 8;
constexpr int GAP_OPEN_FLAG_D = 4;
constexpr int MATCH_BIT = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 227 * 1024;
// Zero bytes left of column 0 in a ring row: the word formats read
// columns down to c - 3, and column 0 then starts 4-aligned.
constexpr int kPadL = 4;

enum Format : int { kBytes = 0, kPacked = 1, kPacked6 = 2, kPlane2 = 3 };

// Rows of the ring above the row a word is emitted for.
template <int FMT> struct Lag {
  static constexpr int value =
      FMT == kBytes ? 0 : FMT == kPacked ? 1 : FMT == kPacked6 ? 3 : 6;
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Ring geometry for a group of LANES lanes that emits its rows together:
// rows in flight (LANES, one a lane) plus the lag plus the row being
// emitted (plus EXTRA, where rows are emitted later), of LANES C + 8
// bytes (kPadL, column 0, the group's LANES C columns, and zero columns
// on the right), and after them one row that stays zero; 16-byte
// aligned.
template <int LANES, int C, int FMT, int EXTRA = 0> struct RingOf {
  static constexpr int kRows = LANES + 1 + EXTRA + Lag<FMT>::value;
  static constexpr int kRowBytes = LANES * C + 8;
  static constexpr int kBytes = round16((kRows + 1) * kRowBytes);
};

struct Args {
  const uint8_t* ref;
  const uint8_t* query;
  const int* ref_len;
  const int* query_len;
  int B, T, match, mismatch, go, ge;
  void* dir;   // uint8 bytes or int32 words [B, T, T+1]
  int* dir2;   // plane 2 (kPlane2 only)
  int* max_score;
  int* max_i;
  int* max_j;
  int* pos_score;
};

// The warp zero-fills n bytes at global p.
__device__ __forceinline__ void zero_bytes(uint8_t* p, size_t n, int lane) {
  const size_t h = min(static_cast<size_t>(
                           (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15),
                       n);
  if (static_cast<size_t>(lane) < h) at(p, lane) = 0;
  const size_t n16 = (n - h) >> 4;
  uint4* q = reinterpret_cast<uint4*>(p + h);
  for (size_t x = lane; x < n16; x += 32) at(q, x) = make_uint4(0, 0, 0, 0);
  for (size_t x = h + 16 * n16 + lane; x < n; x += 32) at(p, x) = 0;
}

// The split paths: rows are emitted by groups of kGroup lanes; a warp
// runs kLag steps behind its left neighbour and the warps meet every
// kSync steps; the boundary ring holds kBnd entries (csrc/dp.cu's
// align_tiles_split and csrc/dp16.cu's align_tiles_split16 say why).
constexpr int kGroup = 16;
constexpr int kSync = 8;
constexpr int kLag = 31 + kSync;
constexpr int kBnd = 32;

}  // namespace
