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
// has taken ET steps.  One 32-bit load of the word at (i-1, j-1) yields
// the current cell and its three move targets:
//   packed  (format 1): W = D[r,c] | D[r,c+1]<<8 | D[r-1,c]<<16
//                           | D[r-1,c+1]<<24; two steps a load; the op
//                       stream is dense, 2*ET-1 slots;
//   packed6 (format 2): 5-bit fields, plus D[r-2,c-1]<<20 and
//                       D[r-3,c-2]<<25, the MM and MMM diagonal cells;
//                       two to four steps a load, one 4-slot group a
//                       load, a group's unused slots left 0 (holes), as
//                       the JAX walker leaves them.
// Output: op | MATCH_BIT per slot, 0 after the walk, and the steps taken
// on each axis.
//
// What bounds it on the H100: latency.  A walk is a chain of dependent
// word loads (up to ET of them), each one L2 round trip; bytes moved are
// tiny.  The word formats exist to halve or quarter that chain against
// the byte walker (csrc/traceback.cu).
//
// Design: one thread per tile, 128 threads a block, as the byte walker;
// all walks run at once and their load latencies overlap across warps.
// Each thread runs the JAX loop for its own lane and stops when its lane
// stops (a stopped lane records only zeros in the JAX loop), so the
// JAX's lockstep exit test and the packed6 lane compaction, which only
// shorten the lockstep loop, have nothing to do here.  The slot layout
// is the JAX's: the packed walker's pair p at slots 2p, 2p+1, the
// packed6 walker's group g at slots 4g..4g+3.  Per-tile offsets are
// 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GAP_OPEN_FLAG_I = 8;
constexpr int GAP_OPEN_FLAG_D = 4;
constexpr int MATCH_BIT = 16;
constexpr int THREADS = 128;

// State on entering a cell, from the state/byte of the cell left.
__device__ __forceinline__ int resolve(int pstate, int pval, int cur) {
  if (pstate == 3) return cur & 3;
  if (pstate == 2) return (pval & GAP_OPEN_FLAG_I) ? 3 : 2;
  if (pstate == 1) return (pval & GAP_OPEN_FLAG_D) ? 3 : 1;
  return 0;
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
  *upd = false;
  if (!act) return 0;
  const int rec = w.state + (w.state == 3 ? (w.val & MATCH_BIT) : 0);
  const int di = (w.state == 3 || w.state == 2) ? 1 : 0;
  const int dj = w.state == 2 ? 0 : 1;
  w.i -= di;
  w.j -= dj;
  w.is += di;
  w.js += dj;
  if (have_next) {
    const int v = (w.i >= 1 && w.j >= 1) ? v_next : 0;
    w.state = resolve(w.state, w.val, v);
    w.val = v;
    *upd = true;
  }
  return rec;
}

template <int FMT>
__global__ void walk_kernel(const int* __restrict__ words,
                            const int* __restrict__ ref_len,
                            const int* __restrict__ query_len,
                            const uint8_t* __restrict__ first,
                            const int* __restrict__ max_i,
                            const int* __restrict__ max_j, int B, int T,
                            int ET, int width, uint8_t* __restrict__ ops,
                            int* __restrict__ i_steps,
                            int* __restrict__ j_steps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int C = T + 1;
  const int* wm = words + static_cast<int64_t>(b) * T * C;
  // The word at (i-1, j-1), coordinates clipped into the matrix as the
  // JAX walkers clip them; 0 where i < 1 or j < 1.
  auto gather = [&](int i, int j) -> int {
    if (i < 1 || j < 1) return 0;
    return wm[static_cast<int64_t>(min(i - 1, T - 1)) * C + min(j - 1, C - 1)];
  };

  const bool is_first = first[b] != 0;
  // pstate MATCH with pval 0: the first resolve yields the start cell's
  // own op bits.
  Walker w{3, 0, is_first ? max_i[b] : ref_len[b],
           is_first ? max_j[b] : query_len[b], 0, 0};
  uint8_t* out = ops + static_cast<int64_t>(b) * width;
  int s = 0;
  bool chained;
  if (FMT == 1) {
    // Pairs of steps; the JAX keeps the first 2*ET-1 = width slots.
    for (; s < width; s += 2) {
      if (!(w.state != 0 && w.is < ET && w.js < ET)) break;
      const int wd = gather(w.i, w.j);
      const int val = (wd >> 8) & 0xFF;
      w.state = resolve(w.state, w.val, val);
      w.val = val;
      const int moved = w.state == 3   ? (wd >> 16) & 0xFF
                        : w.state == 2 ? (wd >> 24) & 0xFF
                                       : wd & 0xFF;
      out[s] = static_cast<uint8_t>(substep(w, true, moved, true, ET,
                                            &chained));
      const int rec_b = substep(w, true, 0, false, ET, &chained);
      if (s + 1 < width) out[s + 1] = static_cast<uint8_t>(rec_b);
    }
  } else {
    // 4-slot groups; width is a multiple of 4.
    for (; s < width; s += 4) {
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
      out[s] = static_cast<uint8_t>(substep(w, true, vb1, true, ET, &h1));
      // Step B chains only on the MM diagonal, C on MMM, D never.
      out[s + 1] = static_cast<uint8_t>(
          substep(w, h1, (wd >> 20) & 31, m_a && w.state == 3, ET, &h2));
      out[s + 2] = static_cast<uint8_t>(
          substep(w, h2, (wd >> 25) & 31, w.state == 3, ET, &h3));
      out[s + 3] = static_cast<uint8_t>(substep(w, h3, 0, false, ET,
                                                &chained));
    }
  }
  for (; s < width; ++s) out[s] = 0;
  i_steps[b] = w.is;
  j_steps[b] = w.js;
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
  const int blocks = (B + THREADS - 1) / THREADS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt == 1) {
    walk_kernel<1><<<blocks, THREADS, 0, st>>>(
        words, ref_len, query_len, first, max_i, max_j, B, T, ET, width, ops,
        i_steps, j_steps);
  } else if (fmt == 2 && width % 4 == 0) {
    walk_kernel<2><<<blocks, THREADS, 0, st>>>(
        words, ref_len, query_len, first, max_i, max_j, B, T, ET, width, ops,
        i_steps, j_steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
