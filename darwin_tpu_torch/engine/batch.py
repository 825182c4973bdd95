"""GACT batch engine, host-stepped: persistent-slot scheduler around the
tile aligner, plus the GACT call and overlap-record types (the record
line, format_record, is golden/gact.py's, as in darwin_tpu).

The port of darwin_tpu/engine/batch.py (importing that module would
import jax through darwin_tpu.engine), with the same semantics line for
line.  Re-design of GACT_Batch (reference gact.cpp:231-560): BATCH_SIZE
slots each own one in-flight GACT call; every iteration prepares one
tile per slot on the host, aligns the whole batch on the device
(engine/aligner.py::TorchTileAligner: DP + packed6 walk), and advances
each call's state machine (reverse extension -> forward extension ->
emit + refill) on the host.

Parity choices (all mirroring the reference batch path, which agrees
with the scalar GACT path under valid configs):

* phase swap / emission / slot refill happen in the *prepare* step of
  the next iteration (gact.cpp:314-390);
* first tiles re-anchor to the max cell and gate on
  first_tile_score_threshold, skipping op application on failure
  (gact.cpp:449-463, 497-508);
* a tile with zero steps on either axis terminates the phase
  (gact.cpp:545);
* `first` stays set until some tile yields ops (gact.cpp:543).

Scoring is accumulated incrementally from op streams (engine/scoring.py)
instead of materializing aligned strings; the anchor-junction gap-run
correction is applied at emission.  The device engine
(engine/device_batch.py) runs the same state machine on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from darwin_tpu_torch.engine.scoring import ScoreParams, score_ops_batch
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF

SCORE_THRESHOLD = 0  # reference gact.cpp:24


@dataclasses.dataclass
class GactCalls:
    """Anchor set produced by D-SOFT (reference GACT_call, gact.h:35)."""
    ref_id: np.ndarray     # chromosome/piece id
    query_id: np.ndarray   # read id
    ref_pos: np.ndarray    # anchor, chromosome-local
    query_pos: np.ndarray

    def __len__(self) -> int:
        return len(self.ref_id)


@dataclasses.dataclass
class OverlapRecord:
    ref_id: int
    query_id: int
    ab: int
    ae: int
    bb: int
    be: int
    score: int
    comp: bool
    # Matched (char-equal) columns; not part of the reference record
    # format; carried for PAF output (io/paf.py).  0 under --noscore.
    nmatch: int = 0
    # Total alignment columns (matches + mismatches + gap columns) =
    # op-stream length; PAF column 11.  0 only for records re-parsed
    # from .out text (no op stream available).
    ncols: int = 0


def run_gact_batch(genome: Genome, queries: SeqBank, calls: GactCalls,
                   *, tile_size: int, first_tile_score_threshold: int,
                   sp: ScoreParams, complement: bool, same_file: bool,
                   aligner, batch_size: int,
                   compute_score: bool = True) -> list[OverlapRecord]:
    N = len(calls)
    records: list[OverlapRecord] = []
    if N == 0:
        return records

    B = batch_size
    T = tile_size
    g_piece_start = genome.chr_id_to_start_bin * genome.bin_size
    g_piece_len = genome.piece_lengths

    # Per-call state.
    ref_pos = calls.ref_pos.astype(np.int64).copy()
    query_pos = calls.query_pos.astype(np.int64).copy()
    ref_bpos = ref_pos.copy()
    query_bpos = query_pos.copy()
    first = np.ones(N, dtype=bool)
    reverse = np.ones(N, dtype=bool)
    score = np.zeros(N, dtype=np.int64)
    nmatch = np.zeros(N, dtype=np.int64)
    ncols = np.zeros(N, dtype=np.int64)
    prev_gap = np.zeros(N, dtype=bool)
    has_phase_ops = np.zeros((2, N), dtype=bool)   # [left, right]
    phase_first_gap = np.zeros((2, N), dtype=bool)

    # Slot state.
    assign = np.full(B, -1, dtype=np.int64)
    ninit = min(B, N)
    assign[:ninit] = np.arange(ninit)
    terminate = np.zeros(B, dtype=bool)
    next_callidx = ninit
    calls_done = 0

    ref_tiles = np.empty((B, T), dtype=np.uint8)
    query_tiles = np.empty((B, T), dtype=np.uint8)
    ref_lens = np.empty(B, dtype=np.int64)
    query_lens = np.empty(B, dtype=np.int64)
    firsts_b = np.zeros(B, dtype=bool)
    rev_b = np.zeros(B, dtype=bool)

    def emit(ci: int) -> None:
        s = int(score[ci])
        if has_phase_ops[0, ci] and has_phase_ops[1, ci] \
                and phase_first_gap[0, ci] and phase_first_gap[1, ci]:
            # A gap run spans the anchor junction: both stream-initial
            # sub-runs were charged gap_open; the true merged run is
            # charged once (see scoring.py module docstring).
            s += sp.gap_extend - sp.gap_open
        rid, qid = int(calls.ref_id[ci]), int(calls.query_id[ci])
        keep = not (same_file and rid == qid)
        if compute_score:
            keep = keep and s > SCORE_THRESHOLD
        if keep:
            records.append(OverlapRecord(
                rid, qid, int(ref_bpos[ci]), int(ref_pos[ci]),
                int(query_bpos[ci]), int(query_pos[ci]),
                s if compute_score else 0, complement,
                int(nmatch[ci]), int(ncols[ci])))

    jT = np.arange(T, dtype=np.int64)
    gmax = len(genome.concat) - 1
    qmax = len(queries.flat) - 1

    while calls_done < N:
        # ---- prepare (gact.cpp:298-410) --------------------------------
        # Phase transitions (reverse done -> swap; forward done -> emit
        # + refill) stay scalar but touch only the few slots whose
        # phase actually ended this iteration.
        act0 = np.flatnonzero(assign >= 0)
        ci0 = assign[act0]
        rlt0 = g_piece_len[calls.ref_id[ci0]]
        qlt0 = queries.lengths[calls.query_id[ci0]]
        rev0 = reverse[ci0]
        done0 = np.where(
            rev0,
            (ref_pos[ci0] <= 0) | (query_pos[ci0] <= 0),
            (ref_pos[ci0] >= rlt0) | (query_pos[ci0] >= qlt0))
        for t in act0[done0 | terminate[act0]]:
            ci = int(assign[t])
            if reverse[ci]:
                # Reverse phase done: swap begin/current, go forward.
                ref_bpos[ci], ref_pos[ci] = ref_pos[ci], ref_bpos[ci]
                query_bpos[ci], query_pos[ci] = (query_pos[ci],
                                                 query_bpos[ci])
                reverse[ci] = False
                terminate[t] = False
                prev_gap[ci] = False  # new op stream, open=True
            else:
                emit(ci)
                calls_done += 1
                if next_callidx >= N:
                    assign[t] = -1
                    continue
                ci = next_callidx
                next_callidx += 1
                assign[t] = ci
                terminate[t] = False
                if ref_pos[ci] <= 0 or query_pos[ci] <= 0:
                    reverse[ci] = False
                    ref_bpos[ci] = ref_pos[ci]
                    query_bpos[ci] = query_pos[ci]

        if calls_done >= N and not (assign >= 0).any():
            break

        # Vectorized tile slicing over active slots: one fancy-index
        # gather per bank instead of B Python slice/copy pairs.
        ref_lens.fill(-1)
        act = np.flatnonzero(assign >= 0)
        ci_a = assign[act]
        rid_a = calls.ref_id[ci_a]
        qid_a = calls.query_id[ci_a]
        rev_a = reverse[ci_a]
        rp_a = ref_pos[ci_a]
        qp_a = query_pos[ci_a]
        rl_a = np.where(rev_a, np.minimum(rp_a, T),
                        np.minimum(T, g_piece_len[rid_a] - rp_a))
        ql_a = np.where(rev_a, np.minimum(qp_a, T),
                        np.minimum(T, queries.lengths[qid_a] - qp_a))
        gs_a = g_piece_start[rid_a]
        qs_a = queries.starts[qid_a]
        # Reverse tiles read [pos-len, pos) forward; forward tiles are
        # read back-to-front by the reference kernel (align.cpp:130,
        # reverse=true) — flipped at slice time like the CUDA
        # marshaling (cuda_host.cu:113-142).
        base_r = np.where(rev_a, gs_a + rp_a - rl_a,
                          gs_a + rp_a + rl_a - 1)
        base_q = np.where(rev_a, qs_a + qp_a - ql_a,
                          qs_a + qp_a + ql_a - 1)
        step = np.where(rev_a, 1, -1)
        idx_r = base_r[:, None] + step[:, None] * jT
        idx_q = base_q[:, None] + step[:, None] * jT
        rt = genome.concat[np.clip(idx_r, 0, gmax)]
        qt = queries.flat[np.clip(idx_q, 0, qmax)]
        ref_tiles[act] = np.where(jT < rl_a[:, None], rt, PAD_REF)
        query_tiles[act] = np.where(jT < ql_a[:, None], qt, PAD_QUERY)
        ref_lens[act] = rl_a
        query_lens[act] = ql_a
        firsts_b[act] = first[ci_a]
        rev_b[act] = rev_a

        # ---- device: DP + traceback ------------------------------------
        active = ref_lens >= 0
        res = aligner(ref_tiles, query_tiles,
                      np.maximum(ref_lens, 0), np.maximum(query_lens, 0),
                      firsts_b)

        # ---- postprocess (gact.cpp:427-550) -----------------------------
        # Pass 1: first-tile re-anchoring + threshold gate (vectorized;
        # every call sits in at most one slot, so scatters by call id
        # never collide).
        apply_ops = active.copy()
        rp_t = np.zeros(B, dtype=np.int64)
        qp_t = np.zeros(B, dtype=np.int64)
        first_a = first[ci_a]
        mi_a = res.max_i[act].astype(np.int64)
        mj_a = res.max_j[act].astype(np.int64)
        rp1 = np.where(
            first_a,
            np.where(rev_a, rp_a - rl_a + mi_a, rp_a + rl_a - mi_a),
            rp_a)
        qp1 = np.where(
            first_a,
            np.where(rev_a, qp_a - ql_a + mj_a, qp_a + ql_a - mj_a),
            qp_a)
        reanchor = first_a & rev_a
        ref_bpos[ci_a[reanchor]] = rp1[reanchor]
        query_bpos[ci_a[reanchor]] = qp1[reanchor]
        gated = first_a & (res.score[act] < first_tile_score_threshold)
        terminate[act[gated]] = True
        ref_pos[ci_a[gated]] = rp1[gated]
        query_pos[ci_a[gated]] = qp1[gated]
        apply_ops[act[gated]] = False
        rp_t[act] = np.where(gated, 0, rp1)
        qp_t[act] = np.where(gated, 0, qp1)

        # Pass 2: vectorized scoring of the applied op streams.
        ops = res.ops.copy()
        ops[~apply_ops] = 0
        if compute_score:
            slot_ci = np.maximum(assign, 0)
            rid_b = calls.ref_id[slot_ci]
            qid_b = calls.query_id[slot_ci]
            gs_b = g_piece_start[rid_b]

            def ref_chars(idx):
                return genome.concat[np.clip(
                    gs_b[:, None] + idx, 0, len(genome.concat) - 1)]

            def query_chars(idx):
                return queries.gather(qid_b[:, None], idx)

            pg = prev_gap[slot_ci]
            delta, new_pg, first_gap, n_m = score_ops_batch(
                ops, ref_chars, query_chars, rp_t, qp_t, rev_b, pg, sp)

        has_ops = (ops != 0).any(axis=1)

        # Pass 3: state updates (vectorized scatter by call id).
        upd = np.flatnonzero((assign >= 0) & apply_ops)
        ci_u = assign[upd]
        rev_u = rev_b[upd]
        phase_u = np.where(rev_u, 0, 1)
        j_steps = res.ref_steps[upd].astype(np.int64)    # ref axis
        i_steps = res.query_steps[upd].astype(np.int64)  # query axis
        ncols[ci_u] += (ops[upd] != 0).sum(axis=1)
        if compute_score:
            score[ci_u] += delta[upd].astype(np.int64)
            nmatch[ci_u] += n_m[upd]
            prev_gap[ci_u] = new_pg[upd]
            fresh = has_ops[upd] & ~has_phase_ops[phase_u, ci_u]
            phase_first_gap[phase_u[fresh], ci_u[fresh]] = \
                first_gap[upd][fresh]
            has_phase_ops[phase_u[fresh], ci_u[fresh]] = True
        else:
            ho = has_ops[upd]
            has_phase_ops[phase_u[ho], ci_u[ho]] = True
        first[ci_u[has_ops[upd]]] = False
        sgn = np.where(rev_u, -1, 1)
        ref_pos[ci_u] = rp_t[upd] + sgn * j_steps
        query_pos[ci_u] = qp_t[upd] + sgn * i_steps
        terminate[upd[(i_steps == 0) | (j_steps == 0)]] = True

    return records
