"""The device engine's slot-loop bookkeeping: the CUDA kernels
csrc/slot_loop.cu (slot_prepare, slot_post), their plain versions
slot_prepare_torch and slot_post_torch, and the dispatch between them.

An engine iteration (engine/device_batch.py) runs slot_prepare, the span
fetch, the DP, a walker and slot_post, then reads the five stop values
from ctl.  The buffers, all on the engine's device:

* cs [N+1, 16] int32, the per-call state in CSTATE_COLS order (flags as
  0/1); row N is a dump row that stays zero;
* calls [N+1, 8] int64, the per-call constants: g_start, q_start,
  g_len, q_len, rid, qid, comp, 0 (G_START .. COMP); row N zero;
* assign [B] int32, each slot's call (-1: none);
* ctl [8] int64: calls_done, next_ci, active, act_sum, nrec (the stop
  check's five values, in its order), then unused;
* records [N+1, 10] int32, the record table;
* slot_prepare's outputs for the span fetch and the walker: offs [2, B]
  int64 (the tiles' bank offsets), lens [2, B] int32 (rl, ql) and flags
  [2, B] bool (backward, first).

The plain versions are the PyTorch loop's arithmetic
(DeviceGactEngine._loop_torch) over these buffers; a slot with no call
writes nothing, so the dump rows stay as they were.
"""

from __future__ import annotations

import torch

from darwin_tpu_torch import _build
from darwin_tpu_torch.engine.batch import SCORE_THRESHOLD

I32 = torch.int32
I64 = torch.int64

# The per-call state matrix's columns (the JAX engine's CSTATE layout).
CSTATE_COLS = ("rpos", "qpos", "rbpos", "qbpos", "first", "reverse",
               "prev_gap", "term", "done", "score", "nmat", "ncol", "hp0",
               "hp1", "fg0", "fg1")
(RPOS, QPOS, RBPOS, QBPOS, FIRST, REVERSE, PREV_GAP, TERM, DONE, SCORE,
 NMAT, NCOL, HP0, HP1, FG0, FG1) = range(16)
G_START, Q_START, G_LEN, Q_LEN, RID, QID, COMP = range(7)
CALLS_DONE, NEXT_CI, ACTIVE, ACT_SUM, NREC = range(5)


def _score_ops(opsT: torch.Tensor, mbitsT: torch.Tensor,
               prev_gap: torch.Tensor, *, match: int, mismatch: int,
               gap_open: int, gap_extend: int):
    """Port of darwin_tpu/engine/device_batch.py::_score_ops.

    opsT: [B, S] ops (0 = none), mbitsT: [B, S] bool MATCH_BIT of each
    MATCH op, prev_gap: [B] bool whether the call's last op so far was
    a gap.  Zero slots are skipped when looking back for the previous
    op (the packed6 walker leaves holes; the lookback is harmless on
    the other walkers' dense ops).

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


def slot_prepare_torch(cs, calls, assign, ctl, records, offs, lens, flags,
                       *, T: int, gap_diff: int, same_file: bool,
                       compute_score: bool) -> None:
    """Plain version of slot_prepare, in place (gact.cpp:298-410): the
    phase swap, emission into records at nrec + the kept slots'
    exclusive rank, done, the refill with next_ci + the done slots'
    exclusive rank and the fresh edge-anchor skip; then the fetch's
    arguments into offs, lens and flags, and the stop values into ctl.
    gap_diff is gap_extend - gap_open, the junction correction."""
    N = cs.shape[0] - 1
    a = assign.to(I64)
    act = a >= 0
    ci = torch.where(act, a, N)
    r = cs[ci]
    c = calls[ci]
    rev = r[:, REVERSE] != 0
    swap = act & rev & ((r[:, RPOS] <= 0) | (r[:, QPOS] <= 0)
                        | (r[:, TERM] != 0))
    sw = r[swap]
    sw[:, [RPOS, RBPOS, QPOS, QBPOS]] = sw[:, [RBPOS, RPOS, QBPOS, QPOS]]
    sw[:, [REVERSE, PREV_GAP, TERM]] = 0
    cs[ci[swap]] = sw

    # Emission: the forward extension finished.
    done = act & ~rev & ((r[:, RPOS] >= c[:, G_LEN])
                         | (r[:, QPOS] >= c[:, Q_LEN]) | (r[:, TERM] != 0))
    fscore = r[:, SCORE] + (r[:, HP0] & r[:, HP1] & r[:, FG0]
                            & r[:, FG1]) * gap_diff
    kept = done
    if same_file:
        kept = kept & (c[:, RID] != c[:, QID])
    if compute_score:
        kept = kept & (fscore > SCORE_THRESHOLD)
    rows = torch.stack(
        [c[:, RID].to(I32), c[:, QID].to(I32), r[:, RBPOS], r[:, RPOS],
         r[:, QBPOS], r[:, QPOS],
         fscore if compute_score else torch.zeros_like(fscore),
         c[:, COMP].to(I32), r[:, NMAT], r[:, NCOL]], dim=1)
    kept64 = kept.to(I64)
    krank = torch.cumsum(kept64, 0) - kept64
    records[(ctl[NREC] + krank)[kept]] = rows[kept]
    cs[ci[done], DONE] = 1

    # Refill, and the fresh calls anchored at an edge skip the reverse
    # phase.
    done64 = done.to(I64)
    n_done = done64.sum()
    fresh = ctl[NEXT_CI] + torch.cumsum(done64, 0) - done64
    got = done & (fresh < N)
    a = torch.where(done, torch.where(got, fresh, -1), a)
    fr = fresh[got]
    rf = cs[fr]
    skip = (rf[:, RPOS] <= 0) | (rf[:, QPOS] <= 0)
    rf = rf[skip]
    rf[:, REVERSE] = 0
    rf[:, RBPOS] = rf[:, RPOS]
    rf[:, QBPOS] = rf[:, QPOS]
    cs[fr[skip]] = rf
    assign.copy_(a)

    # The fetch's arguments: reverse tiles read [pos - len, pos) forward,
    # forward tiles [pos, pos + len) back to front.
    act = a >= 0
    ci = torch.where(act, a, N)
    r = cs[ci]
    c = calls[ci]
    rev = r[:, REVERSE] != 0
    p_r, p_q = r[:, RPOS], r[:, QPOS]
    rl = torch.where(rev, p_r.clamp(max=T),
                     (c[:, G_LEN].to(I32) - p_r).clamp(max=T))
    ql = torch.where(rev, p_q.clamp(max=T),
                     (c[:, Q_LEN].to(I32) - p_q).clamp(max=T))
    rl = torch.where(act, rl.clamp(min=0), 0)
    ql = torch.where(act, ql.clamp(min=0), 0)
    offs[0] = torch.where(act, c[:, G_START]
                          + torch.where(rev, p_r - rl, p_r), 0)
    offs[1] = torch.where(act, c[:, Q_START]
                          + torch.where(rev, p_q - ql, p_q), 0)
    lens[0] = rl
    lens[1] = ql
    flags[0] = act & ~rev
    flags[1] = act & (r[:, FIRST] != 0)

    active = act.sum()
    ctl[CALLS_DONE] += n_done
    ctl[NEXT_CI] = (ctl[NEXT_CI] + n_done).clamp(max=N)
    ctl[ACTIVE] = active
    ctl[ACT_SUM] += active
    ctl[NREC] += kept64.sum()


def slot_post_torch(cs, assign, lens, out: dict, raw, i_steps, j_steps, *,
                    threshold: int, compute_score: bool, match: int,
                    mismatch: int, gap_open: int, gap_extend: int) -> None:
    """Plain version of slot_post, in place (gact.cpp:427-550): each
    slot's call takes its tile's result (out: the DP's max_score, max_i,
    max_j, pos_score; the walker's raw op stream [B, W] and steps)."""
    sel = (assign >= 0).nonzero()[:, 0]
    ci = assign[sel].to(I64)
    r = cs[ci]
    rl, ql = lens[0][sel], lens[1][sel]
    rev = r[:, REVERSE] != 0
    first = r[:, FIRST] != 0
    p_r, p_q = r[:, RPOS], r[:, QPOS]
    max_i, max_j = out["max_i"][sel], out["max_j"][sel]
    tscore = torch.where(first, out["max_score"][sel],
                         out["pos_score"][sel])
    ra_r = torch.where(rev, p_r - rl + max_i, p_r + rl - max_i)
    ra_q = torch.where(rev, p_q - ql + max_j, p_q + ql - max_j)
    rp_t = torch.where(first, ra_r, p_r)
    qp_t = torch.where(first, ra_q, p_q)
    thr_fail = first & (tscore < threshold)
    apply = ~thr_fail

    # First reverse tiles re-anchor the begin positions.
    fr = first & rev
    r[fr, RBPOS] = rp_t[fr]
    r[fr, QBPOS] = qp_t[fr]

    raw = raw[sel]
    ops = (raw & 3) * apply[:, None]
    n_ops = (ops != 0).sum(dim=1, dtype=I32)
    prev_gap = r[:, PREV_GAP] != 0
    if compute_score:
        delta, new_pg, first_gap, has_ops, n_m = _score_ops(
            ops, raw >= 16, prev_gap, match=match, mismatch=mismatch,
            gap_open=gap_open, gap_extend=gap_extend)
        r[:, SCORE] += delta * apply
        r[:, NMAT] += n_m * apply
        r[:, PREV_GAP] = torch.where(apply, new_pg, prev_gap).to(I32)
    else:
        has_ops = (ops != 0).any(dim=1)
        first_gap = torch.zeros_like(has_ops)
    r[:, NCOL] += n_ops

    # Phase bookkeeping for the junction correction.
    has = apply & has_ops
    new0 = has & rev & (r[:, HP0] == 0)
    new1 = has & ~rev & (r[:, HP1] == 0)
    r[new0, FG0] = first_gap[new0].to(I32)
    r[new1, FG1] = first_gap[new1].to(I32)
    r[new0, HP0] = 1
    r[new1, HP1] = 1
    r[has, FIRST] = 0

    steps_i = torch.where(apply, i_steps[sel], 0)
    steps_j = torch.where(apply, j_steps[sel], 0)
    r[:, RPOS] = torch.where(
        apply, torch.where(rev, rp_t - steps_i, rp_t + steps_i), rp_t)
    r[:, QPOS] = torch.where(
        apply, torch.where(rev, qp_t - steps_j, qp_t + steps_j), qp_t)
    new_term = thr_fail | (apply & ((steps_i == 0) | (steps_j == 0)))
    r[new_term, TERM] = 1
    cs[ci] = r


def _check_state(cs, calls, assign, what):
    """The device, N and B of the state buffers, checked."""
    dev = _build.require_cuda(cs, what)
    if cs.dim() != 2 or cs.shape[0] < 2:
        raise ValueError(f"{what}: cs must be [N+1, 16], N >= 1, got "
                         f"{tuple(cs.shape)}")
    N = cs.shape[0] - 1
    if N >= 2 ** 31 - 1:
        raise ValueError(f"{what}: {N} calls exceed int32")
    _build.arg(cs, "cs", I32, (N + 1, 16), dev)
    if cs.storage_offset() % 4:  # the kernels load a row as four int4
        raise ValueError(f"{what}: cs does not start a 16-byte unit")
    if calls is not None:
        _build.arg(calls, "calls", I64, (N + 1, 8), dev)
    if assign.dim() != 1 or assign.shape[0] < 1:
        raise ValueError(f"{what}: assign must be [B], B >= 1, got "
                         f"{tuple(assign.shape)}")
    B = assign.shape[0]
    _build.arg(assign, "assign", I32, (B,), dev)
    return dev, N, B


def slot_prepare(cs, calls, assign, ctl, records, offs, lens, flags, *,
                 T: int, gap_diff: int, same_file: bool,
                 compute_score: bool) -> None:
    """Same contract as slot_prepare_torch; one launch of
    csrc/slot_loop.cu's slot_prepare, counted on slot_prepare.launches."""
    kw = dict(T=T, gap_diff=gap_diff, same_file=same_file,
              compute_score=compute_score)
    if cs.device.type == "cpu":
        return slot_prepare_torch(cs, calls, assign, ctl, records, offs,
                                  lens, flags, **kw)
    dev, N, B = _check_state(cs, calls, assign, "slot_prepare")
    if T < 1:
        raise ValueError(f"slot_prepare: T={T}")
    _build.launch("dtt_slot_prepare", dev, cs, calls, assign,
                  _build.arg(ctl, "ctl", I64, (8,), dev),
                  _build.arg(records, "records", I32, (N + 1, 10), dev),
                  _build.arg(offs, "offs", I64, (2, B), dev),
                  _build.arg(lens, "lens", I32, (2, B), dev),
                  _build.arg(flags, "flags", torch.bool, (2, B), dev),
                  N, B, T, gap_diff, int(same_file), int(compute_score))
    slot_prepare.launches += 1


def slot_post(cs, assign, lens, out: dict, raw, i_steps, j_steps, *,
              threshold: int, compute_score: bool, match: int,
              mismatch: int, gap_open: int, gap_extend: int) -> None:
    """Same contract as slot_post_torch; one launch of
    csrc/slot_loop.cu's slot_post, counted on slot_post.launches."""
    sc = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if cs.device.type == "cpu":
        return slot_post_torch(cs, assign, lens, out, raw, i_steps, j_steps,
                               threshold=threshold,
                               compute_score=compute_score, **sc)
    dev, N, B = _check_state(cs, None, assign, "slot_post")
    if raw.dim() != 2 or raw.shape[0] != B or raw.shape[1] < 1:
        raise ValueError(f"slot_post: raw must be [{B}, W], W >= 1, got "
                         f"{tuple(raw.shape)}")
    W = raw.shape[1]
    _build.launch("dtt_slot_post", dev, cs, assign,
                  _build.arg(lens, "lens", I32, (2, B), dev),
                  *(_build.arg(out[k], k, I32, (B,), dev)
                    for k in ("max_i", "max_j", "max_score", "pos_score")),
                  _build.arg(raw, "raw", torch.uint8, (B, W), dev),
                  _build.arg(i_steps, "i_steps", I32, (B,), dev),
                  _build.arg(j_steps, "j_steps", I32, (B,), dev),
                  B, W, threshold, match, mismatch, gap_open, gap_extend,
                  int(compute_score))
    slot_post.launches += 1


slot_prepare.launches = 0
slot_post.launches = 0
