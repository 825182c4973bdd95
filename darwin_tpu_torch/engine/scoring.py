"""Vectorized incremental affine rescoring of traceback op streams.

A copy of darwin_tpu/engine/scoring.py, which cannot be imported without
jax (through darwin_tpu/engine/__init__.py).  The host-stepped engine
(engine/batch.py::run_gact_batch) scores each iteration's op streams
with it.

The reference recomputes each overlap's total score from the stitched
aligned strings at the end (gact.cpp:197-210 / :330-344): a column with
a gap in either string contributes gap_open if the previous column had
none, else gap_extend; other columns contribute match/mismatch by char
equality.  Materializing the strings is O(alignment length) Python work
per call; instead we accumulate the score per batch iteration directly
from the op stream [B, S], which is equivalent because:

* a column is a gap column iff its op is INSERT or DELETE;
* gap-run decomposition go + (n-1)*ge is direction-independent, so the
  left-extension stream (which arrives in reverse string order) scores
  the same run total as the string does;
* the only coupling between the left and right streams is a gap run
  spanning the anchor junction: both sub-runs get charged go, while the
  true merged run is charged once — corrected at emission time by
  (gap_extend - gap_open) when the left stream's first column and the
  right stream's first column are both gaps (see run_gact_batch).

Char indices follow the replay loops (gact.cpp:475-491, 520-536):
reverse phase reads pos - consumed - 1 going down; forward phase reads
pos + consumed going up; gap columns never need chars.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ScoreParams:
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int


def score_ops_batch(ops: np.ndarray, ref_chars_at, query_chars_at,
                    ref_pos: np.ndarray, query_pos: np.ndarray,
                    reverse: np.ndarray, prev_gap: np.ndarray,
                    sp: ScoreParams
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Score one batch iteration's op streams.

    Args:
      ops: [B, S] uint8 (0 = none; streams are left-compacted).
      ref_chars_at / query_chars_at: callables idx[B,S] -> chars[B,S],
        gathering from each row's source sequence (clipped indices are
        fine for masked columns).
      ref_pos, query_pos: [B] positions *after first-tile re-anchoring*.
      reverse: [B] bool, True for left-extension (reverse) tiles.
      prev_gap: [B] bool carry — was the previous arrival column in this
        phase a gap?  (False at phase start: reference open=True.)

    Returns:
      (delta_score [B], new prev_gap [B], first_col_gap [B] — whether
      the first valid column of THIS iteration is a gap; callers use it
      only on the iteration that starts a phase).
    """
    B, S = ops.shape
    valid = ops != 0
    is_gap = (ops == 1) | (ops == 2)          # DELETE / INSERT
    is_m = ops == 3

    # Ref axis consumed by M and I ops, query axis by M and D ops
    # (replay counters j and i, gact.cpp:477-491).
    ref_consume = is_m | (ops == 2)
    query_consume = is_m | (ops == 1)
    j_before = np.cumsum(ref_consume, axis=1) - ref_consume
    i_before = np.cumsum(query_consume, axis=1) - query_consume

    rev = reverse[:, None]
    ref_idx = np.where(rev, ref_pos[:, None] - j_before - 1,
                       ref_pos[:, None] + j_before)
    query_idx = np.where(rev, query_pos[:, None] - i_before - 1,
                         query_pos[:, None] + i_before)

    rc = ref_chars_at(np.clip(ref_idx, 0, None))
    qc = query_chars_at(np.clip(query_idx, 0, None))
    m_contrib = np.where(rc == qc, sp.match, sp.mismatch)

    # Previous-op gap flag with hole skipping: the packed6 walker
    # (ops/traceback.py) records 4-slot groups where a lane may leave
    # up to two trailing zero slots, so the previous op of a column can
    # sit 1-3 slots back.  Lookback picks the nearest VALID column;
    # columns before the stream read the prev_gap carry.  For hole-free
    # streams this reduces exactly to the adjacent-column rule.
    pg = prev_gap[:, None]
    gpad = np.concatenate([np.broadcast_to(pg, (B, 3)), is_gap], axis=1)
    vpad = np.concatenate([np.ones((B, 3), bool), valid], axis=1)
    g1, v1 = gpad[:, 2: 2 + S], vpad[:, 2: 2 + S]
    g2, v2 = gpad[:, 1: 1 + S], vpad[:, 1: 1 + S]
    g3 = gpad[:, 0: S]
    prev_col_gap = np.where(v1, g1, np.where(v2, g2, g3))
    gap_contrib = np.where(prev_col_gap, sp.gap_extend, sp.gap_open)

    contrib = np.where(is_m, m_contrib, gap_contrib) * valid
    delta = contrib.sum(axis=1)
    n_match = (is_m & (rc == qc) & valid).sum(axis=1)

    has_ops = valid.any(axis=1)
    last_idx = np.where(has_ops, valid.shape[1] - 1 -
                        np.argmax(valid[:, ::-1], axis=1), 0)
    last_gap = is_gap[np.arange(B), last_idx]
    new_prev_gap = np.where(has_ops, last_gap, prev_gap)

    first_col_gap = is_gap[:, 0] & valid[:, 0]
    return (delta.astype(np.int64), new_prev_gap, first_col_gap,
            n_match.astype(np.int64))
