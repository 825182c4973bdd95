// GACT traceback walker over dir bytes, for Hopper (sm_90a).
//
// Replaces: darwin_tpu/ops/traceback.py, traceback_jax (line 29), the
// walker the JAX engine runs after the DP.  That walker is plain XLA,
// not Pallas; it is a kernel here because in eager PyTorch the walk
// would be up to 2*ET-1 Python-driven steps of about 15 small launches
// each, every engine iteration.  Its PyTorch port, and this kernel's
// plain version, is darwin_tpu_torch/ops/traceback.py::traceback_torch.
//
// What it computes: per tile, the walk from (max_i, max_j) for first
// tiles or (rlen, qlen) otherwise, until a ZERO op or until either axis
// has taken ET steps; INSERT/DELETE switch to MATCH on the *current*
// cell's gap-open flag.  Row 0 and column 0 (and anything above or left
// of them) read as ZERO; coordinates past the matrix are clipped into
// it as traceback_jax clips them.  Output: the dense op stream
// [B, 2*ET-1] uint8 (op | MATCH_BIT for MATCH ops on equal chars, 0
// after the walk) and the steps taken on each axis.
//
// What bounds it on the H100: latency.  A walk is a chain of up to
// 2*ET-1 dependent steps, each reading the byte of the cell it enters;
// the bytes moved are tiny.  The matrix (B*T*(T+1) bytes, 52.6 MB at
// B = 512, T = 320) is larger than the H100's 50 MB L2, and one
// dependent global load costs 0.5-2 us.
//
// Design: one warp a tile, WARPS warps a block.  The warp copies a
// window of its tile's matrix into shared memory: WIN_R = 32 rows by
// WIN_C = 64 columns ending at the current cell, each lane issuing its
// WIN_R * WIN_C / 32 loads together, so a window costs about one memory
// round trip (64 x 64 windows measured no faster on the H100, 32 x 128
// slower).  Every lane then walks the same walk from shared memory
// (broadcast reads, no divergence) until it leaves the window at its
// top or left edge, where the warp loads the window ending at the new
// cell.  Walks only move up and left, so a diagonal walk of ET = 200
// needs about 7 windows of 32 rows instead of 399 global round trips.
// The walker tracks its offset in the window and issues each step's
// shared read before the bounds checks that may drop it.  Op records
// go to a shared buffer of 2*ET-1 bytes a warp, written out coalesced
// with the zero tail when the walk ends.  Past kRecChunk records
// (STRETCH) the buffer holds kRecChunk and is written out whenever it
// fills, the zero tail stored straight to the output row, so any ET is
// taken: the tile does not bound a walk's records (a gap run that
// leaves row 0 or column 0 reads ZERO bytes, whose cleared gap-open
// flag keeps the state, so it goes on until an axis takes ET steps).
// Short streams keep the one-buffer flow, whose step loop carries no
// stretch bookkeeping.

#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

using dtt::at;

constexpr int GAP_OPEN_FLAG_I = 8;
constexpr int GAP_OPEN_FLAG_D = 4;
constexpr int MATCH_BIT = 16;
constexpr int WARPS = 4;
constexpr int WIN_R = 32;
constexpr int WIN_C = 64;
// A warp's op buffer holds at most this many records between flushes.
constexpr int kRecChunk = 2048;

// Copies the window ending at DP cell (ai, aj) of one tile's matrix d:
// win[dr * WIN_C + dc] = cell (ai - dr, aj - dc).  Every load is of a
// row and column clamped into 1..T, so none is conditional and all are
// in flight together; the entries of cells outside rows and columns
// >= 1 are never read (the walker reads ZERO there).
__device__ __forceinline__ void load_window(const uint8_t* __restrict__ d,
                                            int T, int ai, int aj,
                                            uint8_t* win, int lane) {
  constexpr int H = WIN_C / 32;
  const int C = T + 1;
  uint8_t v[WIN_R][H];
#pragma unroll
  for (int dr = 0; dr < WIN_R; ++dr) {
    const uint8_t* row =
        d + static_cast<size_t>(min(max(ai - dr, 1), T) - 1) * C;
#pragma unroll
    for (int h = 0; h < H; ++h)
      v[dr][h] = at(row, min(max(aj - 32 * h - lane, 1), T));
  }
  __syncwarp();  // every lane has read the previous window
#pragma unroll
  for (int dr = 0; dr < WIN_R; ++dr) {
#pragma unroll
    for (int h = 0; h < H; ++h) win[dr * WIN_C + 32 * h + lane] = v[dr][h];
  }
  __syncwarp();
}

template <bool STRETCH>
__global__ void __launch_bounds__(WARPS * 32) traceback_kernel(
    const uint8_t* __restrict__ dir, const int* __restrict__ ref_len,
    const int* __restrict__ query_len, const uint8_t* __restrict__ first,
    const int* __restrict__ max_i, const int* __restrict__ max_j, int B,
    int T, int ET, int chunk, int per_warp, uint8_t* __restrict__ ops,
    int* __restrict__ i_steps, int* __restrict__ j_steps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // the whole warp
  uint8_t* win = smem + warp * per_warp;
  uint8_t* rec = win + WIN_R * WIN_C;
  const int S = 2 * ET - 1;
  const uint8_t* d = dir + static_cast<size_t>(b) * T * (T + 1);

  const bool is_first = at(first, b) != 0;
  int i = is_first ? at(max_i, b) : at(ref_len, b);
  int j = is_first ? at(max_j, b) : at(query_len, b);
  // The window covers rows lo_i..lo_i+WIN_R-1 and columns
  // lo_j..lo_j+WIN_C-1; off is the current cell's offset in it.  It
  // starts empty (i < lo_i).
  int lo_i = i + 1, lo_j = j + 1, off = 0;
  // The byte of the cell (i, j) just entered, off already moved to it.
  // The shared read is issued before the checks (clamped into the
  // window, it is always in bounds) and its value dropped where the
  // cell is outside the matrix or the window.
  auto enter = [&]() -> int {
    const int v = win[min(off, WIN_R * WIN_C - 1)];
    if (i < 1 || j < 1) return 0;
    if (i < lo_i || j < lo_j) {
      load_window(d, T, i, j, win, lane);
      lo_i = i - WIN_R + 1;
      lo_j = j - WIN_C + 1;
      off = 0;
      return win[0];
    }
    return v;
  };

  uint8_t* out = ops + static_cast<size_t>(b) * S;
  int val = enter();
  int state = val & 3;
  // The walk in stretches of at most `chunk` records (one stretch unless
  // STRETCH): rec[k] holds slot base + k, and a full buffer is written
  // out before the walk goes on.
  int is = 0, js = 0, s = 0, base = 0;
  for (;;) {
    const int lim = STRETCH ? min(S, base + chunk) : S;
    for (; s < lim; ++s) {
      if (state == 0 || is >= ET || js >= ET) break;
      if (lane == 0)
        rec[s - base] = static_cast<uint8_t>(
            state + (state == 3 ? val & MATCH_BIT : 0));
      const int di = state >> 1;  // MATCH and INSERT move up
      const int dj = state & 1;   // MATCH and DELETE move left
      i -= di;
      j -= dj;
      off += di * WIN_C + dj;
      const int nval = enter();
      if (state == 2) {
        state = (val & GAP_OPEN_FLAG_I) ? 3 : 2;
      } else if (state == 1) {
        state = (val & GAP_OPEN_FLAG_D) ? 3 : 1;
      } else {
        state = nval & 3;
      }
      val = nval;
      is += di;
      js += dj;
    }
    if (!STRETCH || s < lim || s == S) break;  // the walk ended
    __syncwarp();
    for (int k = lane; k < chunk; k += 32) at(out, base + k) = rec[k];
    __syncwarp();
    base += chunk;
  }
  if constexpr (STRETCH) {
    __syncwarp();
    for (int k = lane; k < s - base; k += 32) at(out, base + k) = rec[k];
    for (int k = s + lane; k < S; k += 32) at(out, k) = 0;
  } else {
    for (int k = s + lane; k < S; k += 32) rec[k] = 0;
    __syncwarp();
    for (int k = lane; k < S; k += 32) at(out, k) = rec[k];
  }
  if (lane == 0) {
    at(i_steps, b) = is;
    at(j_steps, b) = js;
  }
}

}  // namespace

extern "C" int dtt_traceback(const uint8_t* dir, const int* ref_len,
                             const int* query_len, const uint8_t* first,
                             const int* max_i, const int* max_j, int B,
                             int T, int ET, uint8_t* ops, int* i_steps,
                             int* j_steps, void* stream) {
  if (B <= 0 || T < 1 || ET < 1 || ET > (1 << 29)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // A warp's window, then its op buffer (16 KB a block at most).
  const bool stretch = 2 * ET - 1 > kRecChunk;
  const int chunk = stretch ? kRecChunk : (2 * ET - 1 + 15) & ~15;
  const int per_warp = WIN_R * WIN_C + chunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  const auto kernel =
      stretch ? traceback_kernel<true> : traceback_kernel<false>;
  kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, WARPS * per_warp, st>>>(
      dir, ref_len, query_len, first, max_i, max_j, B, T, ET, chunk,
      per_warp, ops, i_steps, j_steps);
  return static_cast<int>(cudaGetLastError());
}
