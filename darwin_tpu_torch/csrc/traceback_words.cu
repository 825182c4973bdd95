// GACT traceback walkers over packed direction words, for Hopper
// (sm_90a).
//
// Replaces: darwin_tpu/ops/traceback.py, traceback_packed_jax (line 370)
// and traceback_packed6_jax (line 158).  Those walkers are plain XLA,
// not Pallas; they are a kernel here because in eager PyTorch each walk
// step is a dozen small launches, every engine iteration.  Their
// lockstep PyTorch ports are darwin_tpu_torch/ops/traceback.py::
// traceback_packed_torch and traceback_packed6_torch.
//
// What it computes: per tile, the walk from (max_i, max_j) for first
// tiles or (rlen, qlen) otherwise, until a ZERO op or until either axis
// has taken ET steps.  One 32-bit word at (i-1, j-1) (coordinates
// clipped into the matrix as the JAX walkers clip them, 0 where i < 1
// or j < 1) yields the current cell and its three move targets:
//   packed  (format 1): W = D[r,c] | D[r,c+1]<<8 | D[r-1,c]<<16
//                           | D[r-1,c+1]<<24; two steps a word; the op
//                       stream is dense, 2*ET-1 slots;
//   packed6 (format 2): 5-bit fields, plus D[r-2,c-1]<<20 and
//                       D[r-3,c-2]<<25, the MM and MMM diagonal cells;
//                       two to four steps a word, one 4-slot group a
//                       word, a group's unused slots left 0 (holes), as
//                       the JAX walker leaves them.
// Output: op | MATCH_BIT per slot, 0 after the walk, and the steps taken
// on each axis.
//
// What bounds it on the H100: latency.  A walk is a chain of dependent
// steps, each needing the word of the cell it reached; the bytes moved
// are tiny, but the word matrix (4*B*T*(T+1) bytes, 210 MB at B = 512,
// T = 320) is four times the 50 MB L2, so a word read from global
// memory is a DRAM round trip.
//
// Design: the byte walker's (csrc/traceback.cu).  One warp a tile, four
// warps a block.  The warp copies a window of its tile's words into
// shared memory: WIN_R = 32 rows by WIN_C = 64 columns (8 KB) ending at
// the current cell, each lane issuing its 64 clamped loads together, so
// a window costs about one memory round trip.  Every lane then walks the
// same walk from shared memory (broadcast reads, no divergence) until a
// word it needs lies above or left of the window, where the warp loads
// the window ending there.  Each word read is issued before the checks
// that may drop it.  The walk's state update is selects, not branches.
// Op records go to a shared buffer of `width` bytes a warp, written out
// coalesced with the zero tail when the walk ends; past kRecChunk slots
// (STRETCH) the buffer holds kRecChunk and is written out whenever it
// fills, so any ET is taken (see csrc/traceback.cu).  The slot layout is
// the JAX's: the packed walker's pair p at slots 2p, 2p+1, the packed6
// walker's group g at slots 4g..4g+3; each warp stops with its own walk,
// so the JAX's lockstep exit test and its packed6 lane compaction, which
// only shorten the lockstep loop, have nothing to do here.

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
// A warp's op buffer holds at most this many slots between flushes (a
// multiple of 4, so a packed pair or a packed6 group never straddles).
constexpr int kRecChunk = 2048;

// Copies the window ending at walk cell (ai, aj) of one tile's words w
// ([T, T+1]): win[dr * WIN_C + dc] = the word of cell (ai - dr, aj - dc),
// at (min(i-1, T-1), min(j-1, T)).  Every load is of a row and column
// clamped into the matrix, so none is conditional and all are in flight
// together; entries of cells outside rows and columns >= 1 are never
// read (the walker reads 0 there).
__device__ __forceinline__ void load_window(const int* __restrict__ w,
                                            int T, int ai, int aj, int* win,
                                            int lane) {
  constexpr int H = WIN_C / 32;
  const int C = T + 1;
  int v[WIN_R][H];
#pragma unroll
  for (int dr = 0; dr < WIN_R; ++dr) {
    const int* row = w + static_cast<size_t>(min(max(ai - dr, 1), T) - 1) * C;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      v[dr][h] = at(row, min(max(aj - 32 * h - lane, 1), C) - 1);
    }
  }
  __syncwarp();  // every lane has read the previous window
#pragma unroll
  for (int dr = 0; dr < WIN_R; ++dr) {
#pragma unroll
    for (int h = 0; h < H; ++h) win[dr * WIN_C + 32 * h + lane] = v[dr][h];
  }
  __syncwarp();
}

// State on entering a cell, from the state/byte of the cell left.
__device__ __forceinline__ int resolve(int pstate, int pval, int cur) {
  const int flag = pstate == 2 ? GAP_OPEN_FLAG_I : GAP_OPEN_FLAG_D;
  const int gap = (pval & flag) ? 3 : pstate;
  return pstate == 3 ? cur & 3 : pstate == 0 ? 0 : gap;
}

struct Walker {
  int state, val, i, j, is, js;
};

// One walk step at (w.i, w.j) whose state/byte are (w.state, w.val)
// when `have`: returns the op record, moves, and chains to the entered
// cell's state/byte only when its byte v_next is in the word
// (have_next); otherwise w keeps describing this cell.  *upd says
// whether it chained (the next step's `have`).
__device__ __forceinline__ int substep(Walker& w, bool have, int v_next,
                                       bool have_next, int ET, bool* upd) {
  const bool act = have && w.state != 0 && w.is < ET && w.js < ET;
  const int rec = act ? w.state + (w.state == 3 ? w.val & MATCH_BIT : 0)
                      : 0;
  const int di = act ? w.state >> 1 : 0;  // MATCH and INSERT move up
  const int dj = act ? w.state & 1 : 0;   // MATCH and DELETE move left
  w.i -= di;
  w.j -= dj;
  w.is += di;
  w.js += dj;
  const int v = w.i >= 1 && w.j >= 1 ? v_next : 0;
  *upd = act && have_next;
  w.state = *upd ? resolve(w.state, w.val, v) : w.state;
  w.val = *upd ? v : w.val;
  return rec;
}

template <int FMT, bool STRETCH>
__global__ void __launch_bounds__(WARPS * 32)
    walk_kernel(const int* __restrict__ words,
                const int* __restrict__ ref_len,
                const int* __restrict__ query_len,
                const uint8_t* __restrict__ first,
                const int* __restrict__ max_i, const int* __restrict__ max_j,
                int B, int T, int ET, int width, int chunk, int per_warp,
                uint8_t* __restrict__ ops, int* __restrict__ i_steps,
                int* __restrict__ j_steps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // the whole warp
  int* win = reinterpret_cast<int*>(smem + warp * per_warp);
  uint8_t* rec = smem + warp * per_warp + WIN_R * WIN_C * sizeof(int);
  const int* wm = words + static_cast<size_t>(b) * T * (T + 1);

  const bool is_first = at(first, b) != 0;
  // pstate MATCH with pval 0: the first resolve yields the start cell's
  // own op bits.
  Walker w{3, 0, is_first ? at(max_i, b) : at(ref_len, b),
           is_first ? at(max_j, b) : at(query_len, b), 0, 0};
  // The window ends at cell (ai, aj); it starts empty.
  int ai = -(1 << 30), aj = -(1 << 30);
  // The word of cell (i, j): the shared read is issued first (its index
  // clamped into the window, so it is always in bounds) and dropped
  // where the cell is outside the matrix or the window.
  auto gather = [&](int i, int j) -> int {
    const unsigned dr = static_cast<unsigned>(ai) - static_cast<unsigned>(i);
    const unsigned dc = static_cast<unsigned>(aj) - static_cast<unsigned>(j);
    const int v = win[min(dr * WIN_C + dc, WIN_R * WIN_C - 1u)];
    if (i < 1 || j < 1) return 0;
    if (dr >= WIN_R || dc >= WIN_C) {
      load_window(wm, T, i, j, win, lane);
      ai = i;
      aj = j;
      return win[0];
    }
    return v;
  };

  uint8_t* out = ops + static_cast<size_t>(b) * width;
  // The walk in stretches of at most `chunk` slots (one stretch unless
  // STRETCH): rec[k] holds slot base + k, and a full buffer is written
  // out before the walk goes on.
  int s = 0, base = 0;
  bool chained;
  for (;;) {
    const int lim = STRETCH ? min(width, base + chunk) : width;
    if (FMT == 1) {
      // Pairs of steps; the JAX keeps the first 2*ET-1 = width slots.
      for (; s < lim; s += 2) {
        if (!(w.state != 0 && w.is < ET && w.js < ET)) break;
        const int wd = gather(w.i, w.j);
        const int val = (wd >> 8) & 0xFF;
        w.state = resolve(w.state, w.val, val);
        w.val = val;
        const int moved = w.state == 3   ? (wd >> 16) & 0xFF
                          : w.state == 2 ? (wd >> 24) & 0xFF
                                         : wd & 0xFF;
        const int rec_a = substep(w, true, moved, true, ET, &chained);
        const int rec_b = substep(w, true, 0, false, ET, &chained);
        if (lane == 0) {
          rec[s - base] = static_cast<uint8_t>(rec_a);
          if (s + 1 < width) rec[s - base + 1] = static_cast<uint8_t>(rec_b);
        }
      }
    } else {
      // 4-slot groups; width is a multiple of 4.
      for (; s < lim; s += 4) {
        if (!(w.state != 0 && w.is < ET && w.js < ET)) break;
        const int wd = gather(w.i, w.j);
        const int val = (wd >> 5) & 31;
        w.state = resolve(w.state, w.val, val);
        w.val = val;
        const bool m_a = w.state == 3;
        const int vb1 = w.state == 3   ? (wd >> 10) & 31
                        : w.state == 2 ? (wd >> 15) & 31
                                       : wd & 31;
        bool h1, h2, h3;
        const int ra = substep(w, true, vb1, true, ET, &h1);
        // Step B chains only on the MM diagonal, C on MMM, D never.
        const int rb = substep(w, h1, (wd >> 20) & 31, m_a && w.state == 3,
                               ET, &h2);
        const int rc = substep(w, h2, (wd >> 25) & 31, w.state == 3, ET, &h3);
        const int rd = substep(w, h3, 0, false, ET, &chained);
        if (lane == 0) {
          *reinterpret_cast<uint32_t*>(rec + s - base) =
              static_cast<uint32_t>(ra | rb << 8 | rc << 16 | rd << 24);
        }
      }
    }
    if (!STRETCH || s < lim || s >= width) break;  // the walk ended
    __syncwarp();
    for (int k = lane; k < chunk; k += 32) at(out, base + k) = rec[k];
    __syncwarp();
    base += chunk;
  }
  if constexpr (STRETCH) {
    __syncwarp();
    for (int k = lane; k < s - base && base + k < width; k += 32)
      at(out, base + k) = rec[k];
    for (int k = s + lane; k < width; k += 32) at(out, k) = 0;
  } else {
    for (int k = s + lane; k < width; k += 32) rec[k] = 0;
    __syncwarp();
    for (int k = lane; k < width; k += 32) at(out, k) = rec[k];
  }
  if (lane == 0) {
    at(i_steps, b) = w.is;
    at(j_steps, b) = w.js;
  }
}

}  // namespace

// fmt 1 = packed (width 2*ET-1), 2 = packed6 (width a multiple of 4).
extern "C" int dtt_traceback_words(const int* words, const int* ref_len,
                                   const int* query_len,
                                   const uint8_t* first, const int* max_i,
                                   const int* max_j, int B, int T, int ET,
                                   int fmt, int width, uint8_t* ops,
                                   int* i_steps, int* j_steps,
                                   void* stream) {
  if (B <= 0 || T < 1 || ET < 1 || width < 1 || (fmt != 1 && fmt != 2) ||
      (fmt == 2 && width % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // A warp's window, then its op buffer (40 KB a block at most).
  const bool stretch = width > kRecChunk;
  const int chunk = stretch ? kRecChunk : (width + 15) & ~15;
  const int per_warp = WIN_R * WIN_C * static_cast<int>(sizeof(int)) + chunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  const auto kernel =
      fmt == 1 ? (stretch ? walk_kernel<1, true> : walk_kernel<1, false>)
               : (stretch ? walk_kernel<2, true> : walk_kernel<2, false>);
  kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, WARPS * per_warp, st>>>(
      words, ref_len, query_len, first, max_i, max_j, B, T, ET, width, chunk,
      per_warp, ops, i_steps, j_steps);
  return static_cast<int>(cudaGetLastError());
}
