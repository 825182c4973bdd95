// GACT traceback walker for Hopper (sm_90a).
//
// Replaces: darwin_tpu/ops/traceback.py, traceback_packed6_jax (line
// 156), the walker the JAX engine runs after the DP.  That walker is
// plain XLA, not Pallas; it is a kernel here because in eager PyTorch
// the walk would be up to 2*ET-1 Python-driven steps of about 15 small
// launches each, every engine iteration.  Semantics are those of
// traceback_jax (traceback.py:28-112), whose PyTorch port is
// darwin_tpu_torch/ops/traceback.py::traceback_torch.
//
// What it computes: per tile, the walk from (max_i, max_j) for first
// tiles or (rlen, qlen) otherwise, until a ZERO op or until either axis
// has taken ET steps; INSERT/DELETE switch to MATCH on the *current*
// cell's gap-open flag.  Output: the dense op stream [B, 2*ET-1] uint8
// (op | MATCH_BIT for MATCH ops on equal chars, 0 after the walk) and
// the steps taken on each axis.
//
// What bounds it on the H100: latency.  A walk is a chain of up to
// 2*ET-1 dependent byte loads from the dir matrix (B*T*(T+1) bytes,
// 52.6 MB at B = 512, T = 320: larger than L2 only at far bigger B), so
// each step waits one L2 round trip; bytes moved are tiny.
//
// Design: one thread per tile, 128 threads a block.  All walks run at
// once and their load latencies overlap across warps; nothing is staged
// in shared memory.  The op stream is written as the walk goes and
// zero-filled to its end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GAP_OPEN_FLAG_I = 8;
constexpr int GAP_OPEN_FLAG_D = 4;
constexpr int MATCH_BIT = 16;
constexpr int THREADS = 128;

__global__ void traceback_kernel(
    const uint8_t* __restrict__ dir, const int* __restrict__ ref_len,
    const int* __restrict__ query_len, const uint8_t* __restrict__ first,
    const int* __restrict__ max_i, const int* __restrict__ max_j, int B,
    int T, int ET, uint8_t* __restrict__ ops, int* __restrict__ i_steps,
    int* __restrict__ j_steps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int C = T + 1;
  const int S = 2 * ET - 1;
  const uint8_t* d = dir + static_cast<size_t>(b) * T * C;
  // DP cell (i, j); row 0 and column 0 read as ZERO, coordinates are
  // clipped into the matrix as traceback_jax clips them.
  auto cell = [&](int i, int j) -> int {
    if (i < 1 || j < 1) return 0;
    return d[static_cast<size_t>(min(i, T) - 1) * C + min(j, C - 1)];
  };

  const bool is_first = first[b] != 0;
  int i = is_first ? max_i[b] : ref_len[b];
  int j = is_first ? max_j[b] : query_len[b];
  int val = cell(i, j);
  int state = val & 3;
  int is = 0, js = 0, s = 0;
  uint8_t* out = ops + static_cast<size_t>(b) * S;
  for (; s < S; ++s) {
    if (state == 0 || is >= ET || js >= ET) break;
    const int match_bit = state == 3 ? (val & MATCH_BIT) : 0;
    out[s] = static_cast<uint8_t>(state + match_bit);
    const int di = (state == 3 || state == 2) ? 1 : 0;
    const int dj = state == 2 ? 0 : 1;
    i -= di;
    j -= dj;
    const int nval = cell(i, j);
    int next;
    if (state == 3) {
      next = nval & 3;
    } else if (state == 2) {
      next = (val & GAP_OPEN_FLAG_I) ? 3 : 2;
    } else {
      next = (val & GAP_OPEN_FLAG_D) ? 3 : 1;
    }
    state = next;
    val = nval;
    is += di;
    js += dj;
  }
  for (; s < S; ++s) out[s] = 0;
  i_steps[b] = is;
  j_steps[b] = js;
}

}  // namespace

extern "C" int dtt_traceback(const uint8_t* dir, const int* ref_len,
                             const int* query_len, const uint8_t* first,
                             const int* max_i, const int* max_j, int B,
                             int T, int ET, uint8_t* ops, int* i_steps,
                             int* j_steps, void* stream) {
  const int blocks = (B + THREADS - 1) / THREADS;
  traceback_kernel<<<blocks, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      dir, ref_len, query_len, first, max_i, max_j, B, T, ET, ops, i_steps,
      j_steps);
  return static_cast<int>(cudaGetLastError());
}
