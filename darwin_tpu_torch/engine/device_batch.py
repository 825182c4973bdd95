"""GACT batch engine with the slot loop on the device.

The port of darwin_tpu/engine/device_batch.py::DeviceGactEngine.  The
whole GACT_Batch loop (reference gact.cpp:231-560) runs over device
tensors:

* the sequence banks are uploaded once (device_banks);
* the slot and call tables live on the device; the per-slot state
  machine (phase swap, emission, slot refill, first-tile re-anchoring,
  termination) is masked tensor arithmetic with index_put_ updates.
  Each in-flight call lives in exactly one slot, so updates never
  collide; masked-off lanes all write the one dump row N;
* every iteration fetches one ref and one query tile per slot
  (ops/tile_fetch.py), runs the tile DP (ops/dp.py) and the walker
  (ops/traceback.py), and rescores from the dir bytes' MATCH_BIT;
* finished overlaps are written into an [N, 10] record table on the
  device, downloaded once at the end.

Where the JAX engine is one lax.while_loop, this one is a Python loop
that launches the same steps eagerly.  Its only host syncs are the
termination check, once per iteration, and the final download.  The
loop runs every call to completion; the JAX engine's two-tier drain,
compile prewarm and bank-size buckets exist for XLA compiles and TPU
calibration and are not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from darwin_tpu.index.genome import Genome
from darwin_tpu.utils import bucket_steps
from darwin_tpu_torch.engine.batch import (SCORE_THRESHOLD, GactCalls,
                                           OverlapRecord)
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.ops.common import MATCH_BIT, PAD_QUERY, PAD_REF
from darwin_tpu_torch.ops.dp import align_tiles
from darwin_tpu_torch.ops.tile_fetch import fetch_tiles
from darwin_tpu_torch.ops.traceback import traceback

I32 = torch.int32
I64 = torch.int64


def device_banks(genome: Genome, seqbank: SeqBank,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The genome's padded concatenation and the read bank's flat bytes
    as uint8 tensors on device.  One pad byte is appended to each, so
    an empty bank still has a byte to clip to."""
    def upload(flat, pad):
        a = np.empty(len(flat) + 1, dtype=np.uint8)
        a[:-1] = flat
        a[-1] = pad
        return torch.from_numpy(a).to(device)

    return upload(genome.concat, PAD_REF), upload(seqbank.flat, PAD_QUERY)


def _score_ops(opsT: torch.Tensor, mbitsT: torch.Tensor,
               prev_gap: torch.Tensor, *, match: int, mismatch: int,
               gap_open: int, gap_extend: int):
    """Port of darwin_tpu/engine/device_batch.py::_score_ops.

    opsT: [B, S] ops (0 = none), mbitsT: [B, S] bool MATCH_BIT of each
    MATCH op, prev_gap: [B] bool whether the call's last op so far was
    a gap.  Zero slots are skipped when looking back for the previous
    op (the JAX packed6 walker leaves holes; the dense walker here does
    not, and the lookback is harmless on dense ops).

    Returns (delta score, new prev_gap, first op is a gap, any ops,
    matched columns), each [B]."""
    ops = opsT.to(I32)
    valid = ops != 0
    is_gap = (ops == 1) | (ops == 2)
    is_m = ops == 3
    m_contrib = mbitsT.to(I32) * (match - mismatch) + mismatch

    B2, S2 = ops.shape
    gpad = torch.cat([prev_gap[:, None].expand(B2, 3), is_gap], dim=1)
    vpad = torch.cat([torch.ones((B2, 3), dtype=torch.bool,
                                 device=ops.device), valid], dim=1)
    prev_col_gap = torch.where(
        vpad[:, 2:2 + S2], gpad[:, 2:2 + S2],
        torch.where(vpad[:, 1:1 + S2], gpad[:, 1:1 + S2],
                    gpad[:, 0:S2]))
    gap_contrib = prev_col_gap.to(I32) * (gap_extend - gap_open) + gap_open

    delta = (torch.where(is_m, m_contrib, gap_contrib) * valid).sum(
        dim=1, dtype=I32)
    n_match = (mbitsT & is_m).sum(dim=1, dtype=I32)
    has_ops = valid.any(dim=1)
    last_idx = torch.where(
        has_ops, S2 - 1 - torch.argmax(valid.flip(1).to(I32), dim=1), 0)
    last_gap = is_gap.gather(1, last_idx[:, None])[:, 0]
    new_prev_gap = torch.where(has_ops, last_gap, prev_gap)
    first_col_gap = is_gap[:, 0] & valid[:, 0]
    return delta, new_prev_gap, first_col_gap, has_ops, n_match


class DeviceGactEngine:
    """GACT engine whose slot loop runs on one device, with
    device-resident sequence banks."""

    def __init__(self, genome: Genome, queries: SeqBank, *,
                 tile_size: int, early_terminate: int,
                 first_tile_score_threshold: int, match: int,
                 mismatch: int, gap_open: int, gap_extend: int,
                 same_file: bool, batch_size: int = 256,
                 compute_score: bool = True,
                 device: torch.device | str):
        # Positions inside a piece or read are int32 on the device.
        for what, lengths in (("reference piece", genome.piece_lengths),
                              ("read", queries.lengths)):
            if len(lengths) and int(lengths.max()) >= 2**31 - tile_size:
                raise ValueError(f"a {what} exceeds 2^31 - tile_size "
                                 f"bases")
        self.genome = genome
        self.queries = queries
        self.device = torch.device(device)
        self.T = tile_size
        self.ET = early_terminate
        self.threshold = first_tile_score_threshold
        self.scoring = dict(match=match, mismatch=mismatch,
                            gap_open=gap_open, gap_extend=gap_extend)
        self.same_file = same_file
        self.batch_size = batch_size
        self.compute_score = compute_score
        self._gbank, self._qbank = device_banks(genome, queries,
                                                self.device)
        self._g_start_all = (genome.chr_id_to_start_bin.astype(np.int64)
                             * genome.bin_size)
        self.last_iters = 0
        self.last_active_sum = 0

    def slots(self, n_calls: int) -> int:
        """Slot count for an n_calls batch: surplus slots only add
        per-iteration work, so the pool shrinks to a half-octave bucket
        of the call count (darwin_tpu's _natural_static rule)."""
        return min(self.batch_size, bucket_steps(n_calls, 64))

    def run(self, calls: GactCalls, complement) -> list[OverlapRecord]:
        return self.finish(self.run_async(calls, complement))

    def run_async(self, calls: GactCalls, complement, bank_ids=None):
        """Run the whole batch on the device; returns a handle for
        finish(), which downloads the records.

        The loop's launches are enqueued as it goes; it waits for the
        device only on its per-iteration termination check.
        complement: bool for a single-strand batch, or an [N] array for
        merged-strand batches.  bank_ids (default query_id) indexes the
        query bank when it differs from the record read id (merged
        forward+revcomp banks).
        """
        N = len(calls)
        if N == 0:
            return None
        rid = calls.ref_id.astype(np.int64)
        qid = calls.query_id.astype(np.int64)
        bid = qid if bank_ids is None else np.asarray(bank_ids,
                                                     dtype=np.int64)
        comp = np.broadcast_to(np.asarray(complement, dtype=np.int64),
                               (N,))
        return self._loop(rid, qid, bid, comp, calls.ref_pos,
                          calls.query_pos)

    def finish(self, handle) -> list[OverlapRecord]:
        """Download the records of a run_async handle."""
        if handle is None:
            return []
        records, nrec, iters, act_sum = handle
        n = int(nrec)
        self.last_iters = iters
        self.last_active_sum = int(act_sum)
        return [OverlapRecord(*(int(x) for x in row[:7]), bool(row[7]),
                              int(row[8]), int(row[9]))
                for row in records[:n].cpu().numpy()]

    def _loop(self, rid, qid, bid, comp, ref_pos, query_pos):
        dev = self.device
        N = len(rid)
        B = self.slots(N)
        T, ET = self.T, self.ET
        sc = self.scoring
        DUMP = N  # update target of masked-off lanes

        def table(x, dtype):
            """[N] host values -> [N+1] device column (dump row 0)."""
            a = np.zeros(N + 1, dtype=np.int64)
            a[:N] = x
            return torch.from_numpy(a).to(device=dev, dtype=dtype)

        def flag(value: bool):
            return torch.full((N + 1,), value, dtype=torch.bool, device=dev)

        # Per-call state.
        rpos = table(ref_pos, I32)
        qpos = table(query_pos, I32)
        rbpos = rpos.clone()
        qbpos = qpos.clone()
        first, reverse = flag(True), flag(True)
        prev_gap, termp = flag(False), flag(False)
        hp0, hp1, fg0, fg1 = (flag(False) for _ in range(4))
        score, nmat, ncol = (torch.zeros(N + 1, dtype=I32, device=dev)
                             for _ in range(3))
        # Per-call constants.
        ridp = table(rid, I32)
        qidp = table(qid, I32)
        compp = table(comp, I32)
        g_start = table(self._g_start_all[rid], I64)
        g_len = table(self.genome.piece_lengths[rid], I32)
        q_start = table(self.queries.starts[bid], I64)
        q_len = table(self.queries.lengths[bid], I32)

        slot = torch.arange(B, dtype=I64, device=dev)
        assign = torch.where(slot < N, slot, -1)
        next_ci = torch.tensor(min(B, N), dtype=I64, device=dev)
        calls_done = torch.zeros((), dtype=I64, device=dev)
        nrec = torch.zeros((), dtype=I64, device=dev)
        act_sum = torch.zeros((), dtype=I64, device=dev)
        records = torch.full((N + 1, 10), -1, dtype=I32, device=dev)
        zeros_b = torch.zeros(B, dtype=torch.bool, device=dev)
        ones_b = torch.ones(B, dtype=torch.bool, device=dev)
        zeros_i = torch.zeros(B, dtype=I32, device=dev)
        iters = 0

        def at(mask, ci):
            return torch.where(mask, ci, DUMP)

        while int(calls_done) < N:
            # ---- prepare (gact.cpp:298-410) ---------------------------
            act = assign >= 0
            ci = at(act, assign)
            c_rev = reverse[ci]

            # Phase swap: reverse extension finished.
            swap = act & c_rev & ((rpos[ci] <= 0) | (qpos[ci] <= 0)
                                  | termp[ci])
            old_rpos, old_rbpos = rpos[ci], rbpos[ci]
            old_qpos, old_qbpos = qpos[ci], qbpos[ci]
            w = at(swap, ci)
            rpos[w] = old_rbpos
            rbpos[w] = old_rpos
            qpos[w] = old_qbpos
            qbpos[w] = old_qpos
            reverse[w] = zeros_b
            prev_gap[w] = zeros_b
            termp[w] = zeros_b

            # Emission: forward extension finished (checked on the
            # pre-swap reverse flag, like the reference's if/else).
            fwd_done = act & ~c_rev & ((rpos[ci] >= g_len[ci])
                                       | (qpos[ci] >= q_len[ci])
                                       | termp[ci])
            corr = hp0[ci] & hp1[ci] & fg0[ci] & fg1[ci]
            fscore = score[ci] + corr.to(I32) * (sc["gap_extend"]
                                                 - sc["gap_open"])
            keep = fwd_done
            if self.same_file:
                keep = keep & (ridp[ci] != qidp[ci])
            if self.compute_score:
                keep = keep & (fscore > SCORE_THRESHOLD)
            rows = torch.stack(
                [ridp[ci], qidp[ci], rbpos[ci], rpos[ci], qbpos[ci],
                 qpos[ci], fscore if self.compute_score else zeros_i,
                 compp[ci], nmat[ci], ncol[ci]], dim=1)
            keep64 = keep.to(I64)
            krank = torch.cumsum(keep64, 0) - keep64
            records[torch.where(keep, nrec + krank, N)] = rows
            nrec = nrec + keep64.sum()
            done64 = fwd_done.to(I64)
            calls_done = calls_done + done64.sum()

            # Slot refill.
            new_ci = next_ci + torch.cumsum(done64, 0) - done64
            got_new = fwd_done & (new_ci < N)
            assign = torch.where(fwd_done, torch.where(got_new, new_ci, -1),
                                 assign)
            next_ci = (next_ci + done64.sum()).clamp(max=N)
            # Fresh calls anchored at an edge skip the reverse phase.
            fci = at(got_new, new_ci)
            fresh_skip = got_new & ((rpos[fci] <= 0) | (qpos[fci] <= 0))
            w = at(fresh_skip, fci)
            reverse[w] = zeros_b
            rbpos[w] = rpos[fci]
            qbpos[w] = qpos[fci]

            # ---- tile fetch -------------------------------------------
            act2 = assign >= 0
            ci2 = at(act2, assign)
            rev2 = reverse[ci2]
            p_r = rpos[ci2]
            p_q = qpos[ci2]
            first_b = first[ci2] & act2
            rl = torch.where(rev2, p_r.clamp(max=T),
                             (g_len[ci2] - p_r).clamp(max=T))
            ql = torch.where(rev2, p_q.clamp(max=T),
                             (q_len[ci2] - p_q).clamp(max=T))
            rl = torch.where(act2, rl.clamp(min=0), 0)
            ql = torch.where(act2, ql.clamp(min=0), 0)
            # Reverse tiles read [pos-len, pos) forward; forward tiles
            # read [pos, pos+len) back to front.
            fwd = ~rev2
            ref_t = fetch_tiles(
                self._gbank, g_start[ci2] + torch.where(rev2, p_r - rl, p_r),
                rl, fwd, T=T, pad=PAD_REF)
            query_t = fetch_tiles(
                self._qbank, q_start[ci2] + torch.where(rev2, p_q - ql, p_q),
                ql, fwd, T=T, pad=PAD_QUERY)

            # ---- align ------------------------------------------------
            out = align_tiles(ref_t, query_t, rl, ql, **sc)
            max_i, max_j = out["max_i"], out["max_j"]
            raw, i_steps, j_steps = traceback(
                out["dir"], rl, ql, first_b, max_i, max_j,
                early_terminate=ET)
            tscore = torch.where(first_b, out["max_score"],
                                 out["pos_score"])

            # ---- postprocess (gact.cpp:427-550) -----------------------
            ra_r = torch.where(rev2, p_r - rl + max_i, p_r + rl - max_i)
            ra_q = torch.where(rev2, p_q - ql + max_j, p_q + ql - max_j)
            rp_t = torch.where(first_b, ra_r, p_r)
            qp_t = torch.where(first_b, ra_q, p_q)
            thr_fail = first_b & (tscore < self.threshold) & act2
            apply = act2 & ~thr_fail

            # First reverse tiles re-anchor the begin positions.
            w = at(first_b & rev2, ci2)
            rbpos[w] = rp_t
            qbpos[w] = qp_t

            ops = (raw & 3) * apply[:, None]
            n_ops = (ops != 0).sum(dim=1, dtype=I32)
            wa = at(apply, ci2)
            ncol[wa] = ncol[ci2] + n_ops
            if self.compute_score:
                delta, new_pg, first_gap, has_ops, n_m = _score_ops(
                    ops, raw >= MATCH_BIT, prev_gap[ci2], **sc)
                score[wa] = score[ci2] + delta
                nmat[wa] = nmat[ci2] + n_m
                prev_gap[wa] = new_pg
            else:
                has_ops = (ops != 0).any(dim=1)
                first_gap = zeros_b

            # Phase bookkeeping for the junction correction.
            new0 = apply & has_ops & rev2 & ~hp0[ci2]
            new1 = apply & has_ops & ~rev2 & ~hp1[ci2]
            fg0[at(new0, ci2)] = first_gap
            fg1[at(new1, ci2)] = first_gap
            hp0[at(new0, ci2)] = ones_b
            hp1[at(new1, ci2)] = ones_b
            first[at(apply & has_ops, ci2)] = zeros_b

            i_steps = torch.where(apply, i_steps, 0)
            j_steps = torch.where(apply, j_steps, 0)
            nr = torch.where(rev2, rp_t - i_steps, rp_t + i_steps)
            nq = torch.where(rev2, qp_t - j_steps, qp_t + j_steps)
            w = at(apply | thr_fail, ci2)
            rpos[w] = torch.where(apply, nr, rp_t)
            qpos[w] = torch.where(apply, nq, qp_t)
            new_term = thr_fail | (apply & ((i_steps == 0)
                                            | (j_steps == 0)))
            termp[at(act2, ci2)] = termp[ci2] | new_term

            iters += 1
            act_sum = act_sum + act2.sum()
        return records, nrec, iters, act_sum
