"""GACT batch engine with the slot loop on the device.

The port of darwin_tpu/engine/device_batch.py::DeviceGactEngine.  The
whole GACT_Batch loop (reference gact.cpp:231-560) runs over device
tensors:

* the sequence banks are uploaded once (device_banks); the
  genome's stays on the Genome (genome_bank), so an engine
  built for each batch of reads uploads only the reads;
* the slot and call tables live on the device; the per-slot state
  machine (phase swap, emission, slot refill, first-tile re-anchoring,
  termination) runs on a CUDA device as two kernels an iteration
  (ops/slot_loop.py: slot_prepare before the span fetch, slot_post
  after the walker; _loop_fused), elsewhere as masked tensor arithmetic
  with index_put_ updates (_loop_torch, the kernels' plain version).
  Each in-flight call lives in exactly one slot, so updates never
  collide; masked-off lanes all write (the kernels: read) the one dump
  row N;
* every iteration fetches one ref and one query tile per slot in one
  launch (ops/tile_fetch.py), runs the tile DP (ops/dp.py) and a walker
  (ops/traceback.py), and rescores from the dir bytes' MATCH_BIT.
  tb_format picks the pair, as the JAX engine's tb_format does: "bytes"
  (dir bytes and the byte walker, the default), "packed" or "packed6"
  (the DP's word formats and their walkers; packed6 leaves holes in
  the op stream, which the rescoring's lookback skips);
* finished overlaps are written into an [N, 10] record table on the
  device, downloaded once at the end.

Where the JAX engine is one lax.while_loop, this one is a Python loop
that launches the same steps eagerly.  Its only host syncs are the
stop check, once per iteration (one read of calls_done, next_ci, the
active slot count and the record count together), and the final
download.  The JAX engine's compile prewarm and bank-size buckets exist
for XLA compiles and are not carried over.

The two-tier drain is the JAX engine's: the per-call state is one
[N, 16] int32 matrix in its CSTATE column layout (fresh_state), which
the loop takes as its start and returns at its end.  With the drain
on, the loop stops once every call has been issued and fewer than B/4
slots are still active; finish() then resumes the unfinished calls
from their exported state in a loop of slots(n_undone) slots, and
their records follow the first tier's.  The drain engages where the
JAX engine's does: N > B >= 256 and, with the gate on, a slot-pool
simulation of the calls' costs (_drain_tail_span) that predicts a
deep straggler tail.  The flags drain and drain_gate are the JAX
engine's drain_enabled: (True, True) its auto, (True, False) its
"always", drain=False its False.

ShardedGactEngine runs one DeviceGactEngine a mesh entry (banks
replicated on each), the calls placed by balance_calls, the entries'
loops run in turn (parallel/collectives.on_each).

A run's host time is kept beside last_iters, in last_spans
(darwin_tpu_torch.spans keys; run_device_merged adds them to its
metrics): engine_prepare_s (the call arrays, the drain gate's
simulation and the start state; the second tier's state download),
engine_enqueue_s (the loops' host time outside the stop check's wait:
the per-call tables' upload, the launches, the drain's state export),
engine_wait_s (blocked in the stop check), engine_records_s (the record
table's download and its OverlapRecords), engine_slot_iters (slots
times iterations, both tiers) and engine_fused_iters (the iterations
the two kernels ran: all of them on a CUDA device, none elsewhere).
The loop's two are timers only, never profiler ranges (spans.py says
why).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from darwin_tpu_torch.engine.batch import (SCORE_THRESHOLD, GactCalls,
                                           OverlapRecord)
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.ops.common import MATCH_BIT, PAD_QUERY, PAD_REF
from darwin_tpu_torch.ops.dp import align_tiles, check_tile_size
from darwin_tpu_torch.ops.slot_loop import (CSTATE_COLS, _score_ops,
                                            slot_post, slot_prepare)
from darwin_tpu_torch.ops.tile_fetch import fetch_tile_pair
from darwin_tpu_torch.ops.traceback import WALKERS
from darwin_tpu_torch.parallel.collectives import on_each
from darwin_tpu_torch.spans import count, merge, span
from darwin_tpu_torch.utils import bucket_steps

I32 = torch.int32
I64 = torch.int64


def upload_bank(flat: np.ndarray, pad: int,
                device: torch.device | str) -> torch.Tensor:
    """flat's bytes and one pad byte as a uint8 tensor on device (an
    empty bank still has a byte to clip to): a view of the first
    len(flat) + 1 bytes of a storage rounded up to 16 bytes of pad, so
    the span fetch's aligned 16-byte reads of its last byte stay inside
    the storage."""
    n = len(flat) + 1
    a = np.full(-(-n // 16) * 16, pad, dtype=np.uint8)
    a[:n - 1] = flat
    return torch.from_numpy(a).to(device)[:n]


def genome_bank(genome: Genome, device: torch.device | str,
                metrics: dict | None = None) -> torch.Tensor:
    """The genome's padded concatenation on device (upload_bank with
    PAD_REF), uploaded once a (genome, device) and kept on the genome
    (genome._device_bank), so that engines built for one batch of reads
    after another against one reference upload only their read bank.
    With metrics, adds 1 to genome_bank_uploads where this call
    uploaded, else 0."""
    cache = genome.__dict__.setdefault("_device_bank", {})
    key = str(torch.device(device))
    fresh = key not in cache
    if fresh:
        cache[key] = upload_bank(genome.concat, PAD_REF, device)
    count(metrics, "genome_bank_uploads", int(fresh))
    return cache[key]


def device_banks(genome: Genome, seqbank: SeqBank, device: torch.device,
                 metrics: dict | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The genome's bank (genome_bank: resident on the genome; metrics
    as there) and the read bank's flat bytes (upload_bank with
    PAD_QUERY) as uint8 tensors on device."""
    return (genome_bank(genome, device, metrics),
            upload_bank(seqbank.flat, PAD_QUERY, device))


DONE = CSTATE_COLS.index("done")
_INT_COLS = {"rpos", "qpos", "rbpos", "qbpos", "score", "nmat", "ncol"}


class LoopOut(NamedTuple):
    """What one slot loop leaves: the record table (on the device),
    its record count, the iterations and active slot-iterations it ran,
    calls_done (host ints), the final [N, 16] state matrix on the
    device where the drain stopped the loop early (else None), and its
    spans (engine_enqueue_s, engine_wait_s, engine_slot_iters,
    engine_fused_iters)."""
    records: torch.Tensor
    nrec: int
    iters: int
    act_sum: int
    calls_done: int
    state: torch.Tensor | None
    spans: dict


def fresh_state(ref_pos, query_pos) -> np.ndarray:
    """[N, 16] per-call state matrix for fresh anchors (CSTATE_COLS;
    darwin_tpu's DeviceGactEngine._fresh_state)."""
    N = len(ref_pos)
    cs = np.zeros((N, 16), np.int32)
    cs[:, 0] = cs[:, 2] = ref_pos
    cs[:, 1] = cs[:, 3] = query_pos
    cs[:, 4] = 1  # first
    cs[:, 5] = 1  # reverse phase
    return cs


def _drain_tail_span(costs: np.ndarray, B: int) -> tuple[int, int]:
    """Event-driven slot-pool simulation: N calls with per-call
    iteration costs, issued in order into B persistent slots (a slot
    takes the next queued call when its current one finishes — the
    engine's refill rule).  Returns (tail, total): total = predicted
    engine iterations, tail = iterations the pool runs with fewer than
    B//4 active slots, i.e. the span the two-tier drain could hand to
    a small-B engine.  O(N log B) on the host, run once per dispatch.
    """
    import heapq

    n = len(costs)
    k = min(B, n)
    finish = [int(c) for c in costs[:k]]
    heapq.heapify(finish)
    for c in costs[k:]:
        t = heapq.heappop(finish)
        heapq.heappush(finish, t + int(c))
    f = sorted(finish, reverse=True)
    total = f[0] if f else 0
    q = B // 4
    tail = total - f[q - 1] if q - 1 < len(f) else total
    return tail, total


# The auto gate (darwin_tpu's, calibrated on the TPU): the drain
# engages only on a deep straggler tail that also dominates the run.
DRAIN_MIN_TAIL_ITERS = 64
DRAIN_MIN_TAIL_FRAC = 0.5


def gate_engages(tail: int, total: int) -> bool:
    """Whether the auto gate engages on _drain_tail_span's (tail,
    total)."""
    return tail >= DRAIN_MIN_TAIL_ITERS and tail >= DRAIN_MIN_TAIL_FRAC * total


class DeviceGactEngine:
    """GACT engine whose slot loop runs on one device, with
    device-resident sequence banks (the genome's kept on the genome
    across engines: genome_bank; metrics as there)."""

    def __init__(self, genome: Genome, queries: SeqBank, *,
                 tile_size: int, early_terminate: int,
                 first_tile_score_threshold: int, match: int,
                 mismatch: int, gap_open: int, gap_extend: int,
                 same_file: bool, batch_size: int = 256,
                 compute_score: bool = True,
                 device: torch.device | str, tb_format: str = "bytes",
                 drain: bool = True, drain_gate: bool = True,
                 metrics: dict | None = None):
        if tb_format not in WALKERS:
            raise ValueError(f"tb_format {tb_format!r} not in "
                             f"{tuple(WALKERS)}")
        if torch.device(device).type == "cuda":
            check_tile_size(tile_size, "DeviceGactEngine")
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
        self.tb_format = tb_format
        self.drain = drain
        self.drain_gate = drain_gate
        self._gbank, self._qbank = device_banks(genome, queries,
                                                self.device, metrics)
        self._g_start_all = (genome.chr_id_to_start_bin.astype(np.int64)
                             * genome.bin_size)
        self.last_iters = 0
        self.last_active_sum = 0
        self.last_drain_redispatches = 0
        self.last_spans: dict = {}
        # The gate's (tail, total) of the last run, None where it was
        # not evaluated.
        self.last_drain_gate = None

    def slots(self, n_calls: int) -> int:
        """Slot count for an n_calls batch: surplus slots only add
        per-iteration work, so the pool shrinks to a half-octave bucket
        of the call count (darwin_tpu's _natural_static rule)."""
        return min(self.batch_size, bucket_steps(n_calls, 64))

    def run(self, calls: GactCalls, complement) -> list[OverlapRecord]:
        return self.finish(self.run_async(calls, complement))

    def run_async(self, calls: GactCalls, complement, bank_ids=None):
        """Run the batch on the device (its first tier, where the drain
        engages); returns a handle for finish(), which downloads the
        records.

        The loop's launches are enqueued as it goes; it waits for the
        device only on its per-iteration stop check.
        complement: bool for a single-strand batch, or an [N] array for
        merged-strand batches.  bank_ids (default query_id) indexes the
        query bank when it differs from the record read id (merged
        forward+revcomp banks).
        """
        N = len(calls)
        if N == 0:
            return None
        spans: dict = {}
        with span(spans, "engine_prepare"):
            rid = calls.ref_id.astype(np.int64)
            qid = calls.query_id.astype(np.int64)
            bid = qid if bank_ids is None else np.asarray(bank_ids,
                                                         dtype=np.int64)
            comp = np.broadcast_to(np.asarray(complement, dtype=np.int64),
                                   (N,))
            meta = (rid, qid, bid, comp)
            cstate = fresh_state(calls.ref_pos, calls.query_pos)
            drain = self.drain_threshold(bid, self.slots(N))
        return meta, self._loop(meta, cstate, drain), spans

    def drain_threshold(self, bid: np.ndarray, B: int) -> int:
        """The first tier's drain: the loop stops once every call is
        issued and fewer than this many slots are active (0: it runs to
        completion).  darwin_tpu's _dispatch gate; sets
        last_drain_gate to the simulation's (tail, total) where the
        gate ran it."""
        self.last_drain_gate = None
        if not (self.drain and len(bid) > B and B >= 256):
            return 0
        if self.drain_gate:
            costs = self.queries.lengths[bid] // max(1, self.ET) + 2
            self.last_drain_gate = _drain_tail_span(costs, B)
            if not gate_engages(*self.last_drain_gate):
                return 0
        return B // 4

    def finish(self, handle) -> list[OverlapRecord]:
        """Download the records of a run_async handle and, where the
        drain stopped the loop early, resume the unfinished calls
        (done == 0, in index order) from the exported state in a loop
        of slots(n_undone) slots that runs to completion; its records
        follow the first tier's.  Sets last_iters, last_active_sum,
        last_drain_redispatches and last_spans to the run's."""
        self.last_iters = self.last_active_sum = 0
        self.last_drain_redispatches = 0
        self.last_spans = {}
        if handle is None:
            return []
        meta, out, self.last_spans = handle
        recs = self._tally(out)
        if out.calls_done < len(meta[0]):
            with span(self.last_spans, "engine_prepare"):
                state = out.state.cpu().numpy()
                idx = np.flatnonzero(state[:, DONE] == 0)
            recs += self._tally(self._loop(tuple(m[idx] for m in meta),
                                           state[idx], 0))
            self.last_drain_redispatches = 1
        return recs

    def _tally(self, out: LoopOut) -> list[OverlapRecord]:
        """A loop's records; its counts and spans added to the run's."""
        self.last_iters += out.iters
        self.last_active_sum += out.act_sum
        merge(self.last_spans, out.spans)
        with span(self.last_spans, "engine_records"):
            return self._records(out)

    @staticmethod
    def _records(out: LoopOut) -> list[OverlapRecord]:
        return [OverlapRecord(*(int(x) for x in row[:7]), bool(row[7]),
                              int(row[8]), int(row[9]))
                for row in out.records[:out.nrec].cpu().numpy()]

    def _loop(self, meta, cstate: np.ndarray, drain: int) -> LoopOut:
        """The slot loop over the calls of meta (rid, qid, bid, comp),
        started from cstate ([N, 16], CSTATE_COLS); stops when every
        call is done or, with drain > 0, once every call is issued and
        fewer than drain slots are active.  On a CUDA device the
        bookkeeping runs in two kernels an iteration (_loop_fused), else
        in PyTorch (_loop_torch); both give the same LoopOut."""
        if self.device.type == "cuda":
            return self._loop_fused(meta, cstate, drain)
        return self._loop_torch(meta, cstate, drain)

    def _loop_torch(self, meta, cstate: np.ndarray, drain: int) -> LoopOut:
        """_loop with its bookkeeping as masked PyTorch updates of [N+1]
        columns: the CPU's path, and the plain version the fused loop is
        held to."""
        t_start = time.perf_counter()
        wait = 0.0
        rid, qid, bid, comp = meta
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

        # Per-call state, from the [N, 16] matrix (dump row 0); the loop
        # updates these columns in place.
        cs = torch.zeros((N + 1, 16), dtype=I32, device=dev)
        cs[:N] = torch.from_numpy(np.ascontiguousarray(cstate, np.int32)
                                  ).to(dev)
        cols = [cs[:, i].clone() if name in _INT_COLS else cs[:, i] != 0
                for i, name in enumerate(CSTATE_COLS)]
        (rpos, qpos, rbpos, qbpos, first, reverse, prev_gap, termp, donep,
         score, nmat, ncol, hp0, hp1, fg0, fg1) = cols
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
        # The stop check's host copies: calls done, next call to issue,
        # slots active after the refill (darwin_tpu's loop condition).
        n_done, n_next, n_active, n_act_sum, n_rec = (0, min(B, N),
                                                      min(B, N), 0, 0)

        def at(mask, ci):
            return torch.where(mask, ci, DUMP)

        while n_done < N and not (n_next >= N and n_active < drain):
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
            donep[at(fwd_done, ci)] = ones_b

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
            ref_t, query_t = fetch_tile_pair(
                self._gbank, self._qbank,
                g_start[ci2] + torch.where(rev2, p_r - rl, p_r),
                q_start[ci2] + torch.where(rev2, p_q - ql, p_q), rl, ql,
                ~rev2, T=T, pad_ref=PAD_REF, pad_query=PAD_QUERY)

            # ---- align ------------------------------------------------
            out = align_tiles(ref_t, query_t, rl, ql,
                              dir_format=self.tb_format, **sc)
            max_i, max_j = out["max_i"], out["max_j"]
            key, walk = WALKERS[self.tb_format]
            raw, i_steps, j_steps = walk(out[key], rl, ql, first_b, max_i,
                                         max_j, early_terminate=ET)
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
            active = act2.sum()
            act_sum = act_sum + active
            stop = torch.stack([calls_done, next_ci, active, act_sum, nrec])
            t = time.perf_counter()
            n_done, n_next, n_active, n_act_sum, n_rec = stop.tolist()
            wait += time.perf_counter() - t
        state = None
        if n_done < N:
            state = torch.stack([c[:N].to(I32) for c in cols], dim=1)
        return LoopOut(records, n_rec, iters, n_act_sum, n_done, state, {
            "engine_enqueue_s": time.perf_counter() - t_start - wait,
            "engine_wait_s": wait, "engine_slot_iters": B * iters,
            "engine_fused_iters": 0})

    def _loop_fused(self, meta, cstate: np.ndarray, drain: int) -> LoopOut:
        """_loop with its bookkeeping in ops/slot_loop.py's two kernels
        an iteration, slot_prepare before the span fetch and slot_post
        after the walker, over one [N+1, 16] state matrix (the exported
        state is its first N rows) and an [N+1, 8] call table; the stop
        check copies ctl's five values into pinned memory without
        blocking, then synchronizes the stream once.  Each iteration's
        rl and ql are a fresh tensor.  Counts its iterations on
        engine_fused_iters.  On a CPU device the kernels' plain versions
        run (the tests' path)."""
        t_start = time.perf_counter()
        wait = 0.0
        rid, qid, bid, comp = meta
        dev = self.device
        cuda = dev.type == "cuda"
        N = len(rid)
        B = self.slots(N)
        T, ET = self.T, self.ET
        sc = self.scoring
        key, walk = WALKERS[self.tb_format]

        st = np.zeros((N + 1, 16), np.int32)
        st[:N] = cstate
        flag = [i for i, c in enumerate(CSTATE_COLS) if c not in _INT_COLS]
        st[:N, flag] = st[:N, flag] != 0
        calls = np.zeros((N + 1, 8), np.int64)
        calls[:N, :7] = np.stack(
            [self._g_start_all[rid], self.queries.starts[bid],
             self.genome.piece_lengths[rid], self.queries.lengths[bid], rid,
             qid, comp], axis=1)
        cs = torch.from_numpy(st).to(dev)
        calls = torch.from_numpy(calls).to(dev)
        assign = torch.arange(B, dtype=I32).masked_fill_(
            torch.arange(B) >= N, -1).to(dev)
        n_done, n_next, n_active, n_act_sum, n_rec = (0, min(B, N),
                                                      min(B, N), 0, 0)
        ctl = torch.tensor([n_done, n_next, n_active, n_act_sum, n_rec, 0,
                            0, 0], dtype=I64, device=dev)
        records = torch.full((N + 1, 10), -1, dtype=I32, device=dev)
        offs = torch.empty((2, B), dtype=I64, device=dev)
        flags = torch.empty((2, B), dtype=torch.bool, device=dev)
        stop = torch.empty(8, dtype=I64, pin_memory=True) if cuda else ctl
        iters = 0
        while n_done < N and not (n_next >= N and n_active < drain):
            lens = torch.empty((2, B), dtype=I32, device=dev)
            slot_prepare(cs, calls, assign, ctl, records, offs, lens, flags,
                         T=T, gap_diff=sc["gap_extend"] - sc["gap_open"],
                         same_file=self.same_file,
                         compute_score=self.compute_score)
            rl, ql = lens
            backward, first_b = flags
            ref_t, query_t = fetch_tile_pair(
                self._gbank, self._qbank, offs[0], offs[1], rl, ql, backward,
                T=T, pad_ref=PAD_REF, pad_query=PAD_QUERY)
            out = align_tiles(ref_t, query_t, rl, ql,
                              dir_format=self.tb_format, **sc)
            raw, i_steps, j_steps = walk(out[key], rl, ql, first_b,
                                         out["max_i"], out["max_j"],
                                         early_terminate=ET)
            slot_post(cs, assign, lens, out, raw, i_steps, j_steps,
                      threshold=self.threshold,
                      compute_score=self.compute_score, **sc)
            iters += 1
            if cuda:
                stop.copy_(ctl, non_blocking=True)
            t = time.perf_counter()
            if cuda:
                torch.cuda.current_stream(dev).synchronize()
            n_done, n_next, n_active, n_act_sum, n_rec = stop[:5].tolist()
            wait += time.perf_counter() - t
        return LoopOut(records, n_rec, iters, n_act_sum, n_done,
                       cs[:N] if n_done < N else None, {
                           "engine_enqueue_s": (time.perf_counter() - t_start
                                                - wait),
                           "engine_wait_s": wait,
                           "engine_slot_iters": B * iters,
                           "engine_fused_iters": iters})


def balance_calls(costs: np.ndarray, nd: int) -> list[np.ndarray]:
    """Cost-aware call assignment: greedy LPT (longest job first onto
    the least-loaded device) with per-device counts capped at
    ceil(N/nd), so the shard_map's fixed per-device capacity stays
    minimal while one device never collects all the long-extension
    calls.  Returns nd index arrays (a partition of arange(len(costs))).
    """
    import heapq

    n = len(costs)
    cap = -(-n // nd) if n else 0
    order = np.argsort(-np.asarray(costs), kind="stable")
    heap = [(0, d) for d in range(nd)]
    heapq.heapify(heap)
    out: list[list[int]] = [[] for _ in range(nd)]
    spill: list[tuple[int, int]] = []
    for idx in order:
        while True:
            load, d = heapq.heappop(heap)
            if len(out[d]) < cap:
                break
            spill.append((load, d))
        out[d].append(int(idx))
        heapq.heappush(heap, (load + int(costs[idx]), d))
        for it in spill:
            heapq.heappush(heap, it)
        spill.clear()
    return [np.asarray(x, dtype=np.int64) for x in out]


class ShardedGactEngine:
    """The GACT engine over a mesh (darwin_tpu's ShardedGactEngine): one
    DeviceGactEngine a mesh entry, each with the banks uploaded to its
    device and a slot pool of its own, no traffic between them.

    Calls are placed cost-aware (balance_calls, a call's query length as
    its tile-count estimate), not in contiguous blocks: the run ends
    when the slowest entry finishes.  run_async runs the entries' loops
    in turn (collectives.on_each) and returns when all are done; finish
    downloads the records entry by entry.  The arguments are
    DeviceGactEngine's, with mesh (parallel/mesh.Mesh) in place of
    device."""

    def __init__(self, genome: Genome, queries: SeqBank, *, mesh, **kw):
        self.mesh = mesh
        self.n_dev = mesh.size
        self.genome = genome
        self.queries = queries
        self.device = mesh.devices[0]
        # Sharded runs never drain (darwin_tpu passes drain=0 to its
        # sharded dispatches).
        kw = {**kw, "drain": False}
        self.engines = [DeviceGactEngine(genome, queries, device=d, **kw)
                        for d in mesh.devices]
        self.last_iters = 0
        self.last_active_sum = 0
        self.last_drain_redispatches = 0
        self.last_spans: dict = {}

    def run(self, calls: GactCalls, complement) -> list[OverlapRecord]:
        return self.finish(self.run_async(calls, complement))

    def run_async(self, calls: GactCalls, complement, bank_ids=None):
        """DeviceGactEngine.run_async's contract; each mesh entry runs its
        share of the calls."""
        N = len(calls)
        if N == 0:
            return None
        bid = (calls.query_id if bank_ids is None else bank_ids)
        bid = np.asarray(bid, dtype=np.int64)
        comp = np.broadcast_to(np.asarray(complement, dtype=np.int64), (N,))
        assign = balance_calls(self.queries.lengths[bid].astype(np.int64),
                               self.n_dev)

        def run(i):
            idx = assign[i]
            if not len(idx):
                return None
            part = GactCalls(calls.ref_id[idx], calls.query_id[idx],
                             calls.ref_pos[idx], calls.query_pos[idx])
            return self.engines[i].run_async(part, comp[idx], bid[idx])

        return on_each(self.mesh.devices, run)

    def finish(self, handle) -> list[OverlapRecord]:
        """The records of a run_async handle, mesh entry by mesh entry;
        last_iters, last_active_sum and last_spans are the entries'
        sums."""
        self.last_iters = self.last_active_sum = 0
        self.last_spans = {}
        if handle is None:
            return []
        out = []
        for eng, h in zip(self.engines, handle):
            out += eng.finish(h)
            self.last_iters += eng.last_iters
            self.last_active_sum += eng.last_active_sum
            merge(self.last_spans, eng.last_spans)
        return out
