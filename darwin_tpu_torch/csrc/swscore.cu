// Score-only local Smith-Waterman with affine gaps, any length, for
// Hopper (sm_90a).
//
// Replaces: darwin_tpu/ops/swscore.py, local_score_batch (line 33), the
// exact scorer of the NPBSS score evaluator (darwin_tpu/eval/
// score_eval.py).  That function is plain XLA, not Pallas; it is a
// kernel here because in eager PyTorch each DP row is a dozen launches
// (ops/swscore.py::local_score_batch_torch is its lockstep port).
//
// What it computes: for each pair b, the maximum over rows 1..rlen and
// columns 1..qlen of H = max(M, I, D), where (NEG_INF = 1 << 30)
//   M[i][j] = max(H[i-1][j-1] + s(ref[i-1], query[j-1]), 0), M[i][0] = 0
//   I[i][j] = max(M[i-1][j] + gap_open, I[i-1][j] + gap_extend)
//   D[i][j] = max(M[i][j-1] + gap_open, D[i][j-1] + gap_extend)
// with I and D -NEG_INF in column 0 and row 0, M and H 0 in row 0.  The
// JAX computes D as a prefix max along the row,
// D[j] = max_{k<j} (M[k] + gap_open + (j-1-k) * gap_extend), which is
// the same integer as the recurrence above.  Cells past rlen or qlen
// never feed a valid cell (they lie below or to the right), so the
// kernel does not compute them; the JAX masks them instead.
//
// What bounds it on the H100: the dependency chain of the DP.  Memory
// traffic is small (each pair reads its two sequences once and a
// boundary column per query strip).
//
// Design: one warp per pair.  The query is cut into strips of 32
// columns, lane k owning column j0 + k; within a strip the lanes run a
// wavefront, lane k working on row t - k + 1 at step t, so each lane
// takes the left neighbour's M, D of the same row and its H of the row
// above from lane k - 1 by register shuffle, one step late.  Lane 0
// takes them from a boundary column in global scratch ([B, 3, LR+1]:
// M, D, H of the strip's left column), which lane 31 overwrites row by
// row for the next strip, 31 steps behind lane 0's reads of the same
// row.  Nothing is in shared memory and there is no block barrier.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32)
    sw_kernel(const uint8_t* __restrict__ ref,
              const uint8_t* __restrict__ query,
              const int* __restrict__ ref_len,
              const int* __restrict__ query_len, int LR, int LQ, int match,
              int mismatch, int gap_open, int gap_extend,
              int* __restrict__ scratch, int* __restrict__ best_out) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int rows = min(max(ref_len[b], 0), LR);
  const int cols = min(max(query_len[b], 0), LQ);
  const uint8_t* r = ref + static_cast<int64_t>(b) * LR;
  const uint8_t* q = query + static_cast<int64_t>(b) * LQ;
  int* bM = scratch + static_cast<int64_t>(b) * 3 * (LR + 1);
  int* bD = bM + (LR + 1);
  int* bH = bD + (LR + 1);
  if (lane == 0) bH[0] = 0;  // H of row 0
  __syncwarp();

  int best = 0;
  for (int j0 = 1; j0 <= cols; j0 += 32) {
    const int j = j0 + lane;
    const bool col_ok = j <= cols;
    const int qc = col_ok ? q[j - 1] : -1;
    int m_up = 0, i_up = -NEG_INF;       // this column, row above
    int m_last = 0, d_last = -NEG_INF;   // this column, last row done
    int h_last = 0, h_prev = 0;          // H of that row and the one above
    for (int t = 0; t < rows + 31; ++t) {
      const int i = t - lane + 1;
      int ml = __shfl_up_sync(FULL, m_last, 1);
      int dl = __shfl_up_sync(FULL, d_last, 1);
      int hd = __shfl_up_sync(FULL, h_prev, 1);
      const bool row_ok = i >= 1 && i <= rows;
      if (lane == 0 && row_ok) {
        if (j0 == 1) {  // column 0
          ml = 0;
          dl = -NEG_INF;
          hd = 0;
        } else {
          ml = bM[i];
          dl = bD[i];
          hd = bH[i - 1];
        }
      }
      if (row_ok) {
        const int s = r[i - 1] == qc ? match : mismatch;
        const int m = max(hd + s, 0);
        const int ii = max(m_up + gap_open, i_up + gap_extend);
        const int d = max(ml + gap_open, dl + gap_extend);
        const int h = max(max(m, ii), d);
        if (col_ok) best = max(best, h);
        m_up = m;
        i_up = ii;
        m_last = m;
        d_last = d;
        h_prev = h_last;
        h_last = h;
        if (lane == 31) {
          bM[i] = m;
          bD[i] = d;
          bH[i] = h;
        }
      }
    }
    __syncwarp();  // the boundary column is complete for the next strip
  }
  for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(FULL, best, o));
  if (lane == 0) best_out[b] = best;
}

}  // namespace

// scratch: B * 3 * (LR + 1) ints.
extern "C" int dtt_local_score(const uint8_t* ref, const uint8_t* query,
                               const int* ref_len, const int* query_len,
                               int B, int LR, int LQ, int match,
                               int mismatch, int gap_open, int gap_extend,
                               int* scratch, int* best, void* stream) {
  sw_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      ref, query, ref_len, query_len, LR, LQ, match, mismatch, gap_open,
      gap_extend, scratch, best);
  return static_cast<int>(cudaGetLastError());
}
