// The device engine's slot-loop bookkeeping, for Hopper (sm_90a).
//
// Replaces: darwin_tpu/engine/device_batch.py, the body of the engine's
// lax.while_loop (line 240, `body`), less its span fetch, DP and walker,
// which are kernels of their own.  In eager PyTorch that body was about
// 270 launches of small gathers, scatters and scans over [N+1] columns
// an engine iteration (engine/device_batch.py, DeviceGactEngine's
// _loop_torch), each a few microseconds of the host's time; here it is
// two launches, one before the fetch and one after the walker.  Their
// plain versions are ops/slot_loop.py's slot_prepare_torch and
// slot_post_torch; the engine loop that runs them is held to the PyTorch
// loop, record for record.
//
// The state: the per-call matrix cs [N+1, 16] int32 in CSTATE_COLS
// order, flags stored as 0/1, row N a dump row that stays zero (a slot
// with no call reads it and writes nothing); the call table calls
// [N+1, 8] int64 (g_start, q_start, g_len, q_len, rid, qid, comp, 0;
// row N zero); assign [B] int32 (each slot's call, -1 for
// none); ctl [8] int64 (calls_done, next_ci, active, act_sum, nrec: the
// stop check's five values, which the host copies after slot_post).
//
// slot_prepare (gact.cpp:298-410): each slot's call takes the phase
// swap (its reverse extension finished), or, when its forward extension
// finished, is emitted (the junction-corrected score, the same_file and
// SCORE_THRESHOLD filters) into the record table at nrec + its
// exclusive rank among the slot's kept records, marked done, and the
// slot refilled with call next_ci + its exclusive rank among the done
// slots (a fresh call anchored at an edge skips its reverse phase).
// Both ranks run in slot order, so records, refills and iterations are
// the PyTorch loop's exactly (no atomic counter reorders them).  It then
// writes the span fetch's arguments (offs: g_start + offset, q_start +
// offset; lens: rl, ql; flags: backward, first) and the five values.
// `active` after the refill is active - done + the done slots that took
// a call, so no pass over the slots counts it.
//
// slot_post (gact.cpp:427-550): each slot's call takes the tile's
// result: the first tile's re-anchor and threshold failure, the
// rescoring of the walker's op stream (_score_ops: a MATCH scores match
// or mismatch by its MATCH_BIT; a gap opens or extends by the previous
// op, looking back past up to two holes, as packed6 leaves them), ncol,
// score, nmat, prev_gap, the junction's first-gap bookkeeping, first,
// the new positions and term.
//
// What bounds it on the H100: latency.  The bytes are small: B state
// rows of 64 bytes read and written, B call rows, the op stream (B x
// 399 bytes at ET = 200; 800 for packed6) and the records written, under
// 10 us of HBM time at B = 16,384 (on the H100 with 56% of the slots
// active: slot_prepare 0.089 ms, slot_post 0.023 ms, against about 1.4
// ms of DP an iteration).  slot_prepare's ranks need the slots in
// order, so it is one block of 1024 threads (PREP_THREADS) striding
// over the slots in passes of 16 a thread with a carried prefix: a
// pass's flags by ballots, its warps' counts scanned by one warp, then
// each slot's writes; loads of a slot with no call read the dump row, so
// none is conditional.  slot_post runs one warp a slot: the lanes read
// 32 consecutive op bytes at a time (coalesced), take the three ops
// before each from shuffles, and lane 0 writes the row.

#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

using dtt::at;

// CSTATE_COLS (ops/slot_loop.py).
enum Col {
  RPOS, QPOS, RBPOS, QBPOS, FIRST, REVERSE, PREV_GAP, TERM, DONE, SCORE,
  NMAT, NCOL, HP0, HP1, FG0, FG1, NCOLS
};
// The call table's columns.
enum CallCol {
  G_START, Q_START, G_LEN, Q_LEN, RID, QID, COMP, UNUSED, NCALL
};
// The stop values in ctl.
enum Ctl { CALLS_DONE, NEXT_CI, ACTIVE, ACT_SUM, NREC };

constexpr int SCORE_THRESHOLD = 0;  // engine/batch.py, gact.cpp:24
constexpr int MATCH_BIT = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PREP_THREADS = 1024;
constexpr int PREP_WARPS = PREP_THREADS / 32;
constexpr int KMAX = 16;  // slots a thread in one pass
constexpr int PASS = PREP_THREADS * KMAX;
constexpr int POST_WARPS = 8;

// One state row as four 16-byte loads.
__device__ __forceinline__ void load_row(const int* cs, int ci,
                                         int (&r)[NCOLS]) {
  const int4* p = reinterpret_cast<const int4*>(cs);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = at(p, static_cast<ptrdiff_t>(ci) * 4 + q);
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

// The emitted score: the junction correction where both phases began
// with a gap.
__device__ __forceinline__ int final_score(const int (&r)[NCOLS],
                                           int gap_diff) {
  return r[SCORE] + (r[HP0] & r[HP1] & r[FG0] & r[FG1]) * gap_diff;
}

template <bool kSameFile, bool kScore>
__global__ void __launch_bounds__(PREP_THREADS) slot_prepare_kernel(
    int* cs, const long long* __restrict__ calls, int* assign,
    long long* ctl, int* __restrict__ records, long long* __restrict__ offs,
    int* __restrict__ lens, uint8_t* __restrict__ flags, int N, int B,
    int T, int gap_diff) {
  // Each pass's (done << 32 | kept) counts of warp w's slots of step k at
  // [k * PREP_WARPS + w], then their exclusive prefix in slot order.
  __shared__ unsigned long long counts[KMAX * PREP_WARPS];
  __shared__ unsigned long long pass_total;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1;
  const long long next0 = at(ctl, NEXT_CI);
  const long long nrec0 = at(ctl, NREC);
  long long kept_before = 0, done_before = 0;

  for (int base = 0; base < B; base += PASS) {
    // Phase 1: swaps, and each slot's done and kept flags.
    unsigned kept_bits = 0, done_bits = 0;
#pragma unroll 2
    for (int k = 0; k < KMAX; ++k) {
      const int s = base + k * PREP_THREADS + tid;
      const int a = s < B ? at(assign, s) : -1;
      const int ci = a >= 0 ? a : N;
      int r[NCOLS];
      load_row(cs, ci, r);
      const long long* c = calls + static_cast<ptrdiff_t>(ci) * NCALL;
      const long long g_len = at(c, G_LEN), q_len = at(c, Q_LEN);
      const long long rid = at(c, RID), qid = at(c, QID);
      const bool act = a >= 0;
      const bool rev = r[REVERSE] != 0;
      if (act && rev && (r[RPOS] <= 0 || r[QPOS] <= 0 || r[TERM] != 0)) {
        int* w = cs + static_cast<ptrdiff_t>(ci) * NCOLS;
        at(w, RPOS) = r[RBPOS];
        at(w, RBPOS) = r[RPOS];
        at(w, QPOS) = r[QBPOS];
        at(w, QBPOS) = r[QPOS];
        at(w, REVERSE) = 0;
        at(w, PREV_GAP) = 0;
        at(w, TERM) = 0;
      }
      const bool done = act && !rev &&
                        (r[RPOS] >= g_len || r[QPOS] >= q_len || r[TERM] != 0);
      bool kept = done;
      if (kSameFile) kept = kept && rid != qid;
      if (kScore) kept = kept && final_score(r, gap_diff) > SCORE_THRESHOLD;
      const unsigned kb = __ballot_sync(FULL, kept);
      const unsigned db = __ballot_sync(FULL, done);
      if (lane == 0) {
        counts[k * PREP_WARPS + warp] =
            static_cast<unsigned long long>(__popc(db)) << 32 | __popc(kb);
      }
      kept_bits |= static_cast<unsigned>(kept) << k;
      done_bits |= static_cast<unsigned>(done) << k;
    }
    __syncthreads();
    // The counts' exclusive prefix in slot order (step-major, then warp):
    // lane l scans entries 16 l .. 16 l + 15.
    if (warp == 0) {
      constexpr int E = KMAX * PREP_WARPS / 32;
      unsigned long long v[E], sum = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[e] = counts[lane * E + e];
        sum += v[e];
      }
      unsigned long long inc = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long t = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += t;
      }
      unsigned long long run = inc - sum;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        counts[lane * E + e] = run;
        run += v[e];
      }
      if (lane == 31) pass_total = inc;
    }
    __syncthreads();
    const unsigned long long total = pass_total;

    // Phase 2: records, done, refill, then the fetch's arguments.
#pragma unroll 2
    for (int k = 0; k < KMAX; ++k) {
      const int s = base + k * PREP_THREADS + tid;
      const bool kept = (kept_bits >> k) & 1;
      const bool done = (done_bits >> k) & 1;
      const unsigned kb = __ballot_sync(FULL, kept);
      const unsigned db = __ballot_sync(FULL, done);
      if (s >= B) continue;
      const unsigned long long pre = counts[k * PREP_WARPS + warp];
      int ci = at(assign, s);
      if (done) {
        int r[NCOLS];
        load_row(cs, ci, r);
        const long long* c = calls + static_cast<ptrdiff_t>(ci) * NCALL;
        if (kept) {
          const long long row = nrec0 + kept_before +
                                static_cast<long long>(pre & 0xffffffffu) +
                                __popc(kb & below);
          int* o = records + row * 10;
          at(o, 0) = static_cast<int>(at(c, RID));
          at(o, 1) = static_cast<int>(at(c, QID));
          at(o, 2) = r[RBPOS];
          at(o, 3) = r[RPOS];
          at(o, 4) = r[QBPOS];
          at(o, 5) = r[QPOS];
          at(o, 6) = kScore ? final_score(r, gap_diff) : 0;
          at(o, 7) = static_cast<int>(at(c, COMP));
          at(o, 8) = r[NMAT];
          at(o, 9) = r[NCOL];
        }
        at(cs, static_cast<ptrdiff_t>(ci) * NCOLS + DONE) = 1;
        const long long fresh = next0 + done_before +
                                static_cast<long long>(pre >> 32) +
                                __popc(db & below);
        ci = fresh < N ? static_cast<int>(fresh) : -1;
        at(assign, s) = ci;
        if (ci >= 0) {
          int* w = cs + static_cast<ptrdiff_t>(ci) * NCOLS;
          const int rp = at(w, RPOS), qp = at(w, QPOS);
          if (rp <= 0 || qp <= 0) {
            at(w, REVERSE) = 0;
            at(w, RBPOS) = rp;
            at(w, QBPOS) = qp;
          }
        }
      }
      // The fetch's arguments: reverse tiles read [pos - len, pos)
      // forward, forward tiles [pos, pos + len) back to front.
      const bool act = ci >= 0;
      const int cj = act ? ci : N;
      int r[NCOLS];
      load_row(cs, cj, r);
      const long long* c = calls + static_cast<ptrdiff_t>(cj) * NCALL;
      const bool rev = r[REVERSE] != 0;
      const int pr = r[RPOS], pq = r[QPOS];
      const int g_len = static_cast<int>(at(c, G_LEN));
      const int q_len = static_cast<int>(at(c, Q_LEN));
      const int rl = act ? max(min(rev ? pr : g_len - pr, T), 0) : 0;
      const int ql = act ? max(min(rev ? pq : q_len - pq, T), 0) : 0;
      at(offs, s) = act ? at(c, G_START) + (rev ? pr - rl : pr) : 0;
      at(offs, static_cast<ptrdiff_t>(B) + s) =
          act ? at(c, Q_START) + (rev ? pq - ql : pq) : 0;
      at(lens, s) = rl;
      at(lens, static_cast<ptrdiff_t>(B) + s) = ql;
      at(flags, s) = act && !rev;
      at(flags, static_cast<ptrdiff_t>(B) + s) = act && r[FIRST] != 0;
    }
    kept_before += static_cast<long long>(total & 0xffffffffu);
    done_before += static_cast<long long>(total >> 32);
    __syncthreads();  // counts and pass_total are the next pass's
  }
  if (tid == 0) {
    const long long got = min(done_before, max(0LL, N - next0));
    const long long active = at(ctl, ACTIVE) - done_before + got;
    at(ctl, CALLS_DONE) += done_before;
    at(ctl, NEXT_CI) = min(next0 + done_before, static_cast<long long>(N));
    at(ctl, ACTIVE) = active;
    at(ctl, ACT_SUM) += active;
    at(ctl, NREC) = nrec0 + kept_before;
  }
}

template <bool kScore>
__global__ void __launch_bounds__(POST_WARPS * 32) slot_post_kernel(
    int* cs, const int* __restrict__ assign, const int* __restrict__ lens,
    const int* __restrict__ max_i, const int* __restrict__ max_j,
    const int* __restrict__ max_score, const int* __restrict__ pos_score,
    const uint8_t* __restrict__ raw, const int* __restrict__ i_steps,
    const int* __restrict__ j_steps, int B, int W, int threshold, int match,
    int mismatch, int gap_open, int gap_extend) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * POST_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const int ci = at(assign, b);
  if (ci < 0) return;
  int* row = cs + static_cast<ptrdiff_t>(ci) * NCOLS;
  const bool rev = at(row, REVERSE) != 0;
  const bool first = at(row, FIRST) != 0;
  const int pr = at(row, RPOS), pq = at(row, QPOS);
  const int rl = at(lens, b), ql = at(lens, static_cast<ptrdiff_t>(B) + b);
  const int tscore = first ? at(max_score, b) : at(pos_score, b);
  const bool thr_fail = first && tscore < threshold;
  const int mi = at(max_i, b), mj = at(max_j, b);
  const int rp_t = first ? (rev ? pr - rl + mi : pr + rl - mi) : pr;
  const int qp_t = first ? (rev ? pq - ql + mj : pq + ql - mj) : pq;
  const bool pg0 = at(row, PREV_GAP) != 0;

  // The op stream: n_ops, and with kScore the score's delta, the matches,
  // the last op's gap flag and whether op 0 is a gap.
  int n_ops = 0, delta = 0, n_match = 0;
  bool last_gap = pg0, first_gap = false;
  if (!thr_fail) {
    const uint8_t* ops = raw + static_cast<ptrdiff_t>(b) * W;
    // (valid, gap) of the op 32 positions back; before position 0 every
    // op reads as a valid one with the call's prev_gap.
    unsigned prev = 1u | (pg0 ? 2u : 0u);
    for (int s0 = 0; s0 < W; s0 += 32) {
      const int s = s0 + lane;
      const unsigned v = s < W ? at(ops, s) : 0u;
      const unsigned op = v & 3u;
      const bool valid = op != 0;
      n_ops += valid;
      if (kScore) {
        const bool gap = op == 1 || op == 2;
        const unsigned p = (valid ? 1u : 0u) | (gap ? 2u : 0u);
        unsigned back[3];
#pragma unroll
        for (int d = 1; d <= 3; ++d) {
          const unsigned up = __shfl_up_sync(FULL, p, d);
          const unsigned wrap = __shfl_sync(FULL, prev, (lane - d) & 31);
          back[d - 1] = lane >= d ? up : wrap;
        }
        const bool prev_col_gap = (back[0] & 1u)   ? (back[0] & 2u) != 0
                                  : (back[1] & 1u) ? (back[1] & 2u) != 0
                                                   : (back[2] & 2u) != 0;
        if (op == 3) {
          const bool mbit = v >= MATCH_BIT;
          delta += mbit ? match : mismatch;
          n_match += mbit;
        } else if (valid) {
          delta += prev_col_gap ? gap_extend : gap_open;
        }
        const unsigned vb = __ballot_sync(FULL, valid);
        if (vb != 0) last_gap = __shfl_sync(FULL, gap, 31 - __clz(vb));
        if (s0 == 0) first_gap = __shfl_sync(FULL, gap && valid, 0);
        prev = p;
      }
    }
    n_ops = __reduce_add_sync(FULL, n_ops);
    if (kScore) {
      delta = __reduce_add_sync(FULL, delta);
      n_match = __reduce_add_sync(FULL, n_match);
    }
  }
  if (lane != 0) return;
  // First reverse tiles re-anchor the begin positions, failed or not.
  if (first && rev) {
    at(row, RBPOS) = rp_t;
    at(row, QBPOS) = qp_t;
  }
  bool new_term = true;
  if (!thr_fail) {
    const bool has_ops = n_ops > 0;
    at(row, NCOL) += n_ops;
    if (kScore) {
      at(row, SCORE) += delta;
      at(row, NMAT) += n_match;
      at(row, PREV_GAP) = has_ops ? last_gap : pg0;
    }
    const int fg = kScore && first_gap;
    if (has_ops && rev && at(row, HP0) == 0) {
      at(row, FG0) = fg;
      at(row, HP0) = 1;
    }
    if (has_ops && !rev && at(row, HP1) == 0) {
      at(row, FG1) = fg;
      at(row, HP1) = 1;
    }
    if (has_ops) at(row, FIRST) = 0;
    const int is = at(i_steps, b), js = at(j_steps, b);
    at(row, RPOS) = rev ? rp_t - is : rp_t + is;
    at(row, QPOS) = rev ? qp_t - js : qp_t + js;
    new_term = is == 0 || js == 0;
  } else {
    at(row, RPOS) = rp_t;
    at(row, QPOS) = qp_t;
  }
  if (new_term) at(row, TERM) = 1;
}

}  // namespace

extern "C" int dtt_slot_prepare(int* cs, const long long* calls, int* assign,
                                long long* ctl, int* records,
                                long long* offs, int* lens, uint8_t* flags,
                                int N, int B, int T, int gap_diff,
                                int same_file, int compute_score,
                                void* stream) {
  if (N < 1 || B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  const auto kernel =
      same_file ? (compute_score ? slot_prepare_kernel<true, true>
                                 : slot_prepare_kernel<true, false>)
                : (compute_score ? slot_prepare_kernel<false, true>
                                 : slot_prepare_kernel<false, false>);
  kernel<<<1, PREP_THREADS, 0, st>>>(cs, calls, assign, ctl, records, offs,
                                     lens, flags, N, B, T, gap_diff);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtt_slot_post(int* cs, const int* assign, const int* lens,
                             const int* max_i, const int* max_j,
                             const int* max_score, const int* pos_score,
                             const uint8_t* raw, const int* i_steps,
                             const int* j_steps, int B, int W, int threshold,
                             int match, int mismatch, int gap_open,
                             int gap_extend, int compute_score,
                             void* stream) {
  if (B < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DTT_UPLOAD_EXTENTS(st);
  const auto kernel =
      compute_score ? slot_post_kernel<true> : slot_post_kernel<false>;
  kernel<<<(B + POST_WARPS - 1) / POST_WARPS, POST_WARPS * 32, 0, st>>>(
      cs, assign, lens, max_i, max_j, max_score, pos_score, raw, i_steps,
      j_steps, B, W, threshold, match, mismatch, gap_open, gap_extend);
  return static_cast<int>(cudaGetLastError());
}
