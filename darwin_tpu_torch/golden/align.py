"""Scalar GACT tile aligner: the executable spec for one tile.

The port's copy of darwin_tpu/golden/align.py (numpy only).

Transliterates AlignWithBT (reference align.cpp:60-233) — affine-gap
local DP over one tile plus bounded traceback.  Parity-critical details:

* Three-matrix recurrence where gap-open transitions read the *match*
  matrix (clamped at 0), not H (align.cpp:138-156).
* Direction byte = 2-bit op + "gap-open won" flags 2<<INSERT_OP and
  2<<DELETE_OP, with >= comparisons (align.cpp:162-171).
* Max tracking uses >= so the highest (i, j) in row-major order wins
  ties (align.cpp:173-177).
* ``reverse=True`` reads both sequences back-to-front (align.cpp:130-131).
* Traceback stops at ZERO or when either step count reaches
  early_terminate (align.cpp:204-230).
"""

from __future__ import annotations

import numpy as np

# Op encodings (reference align.h:22-23).
ZERO_OP, DELETE_OP, INSERT_OP, MATCH_OP = 0, 1, 2, 3
Z, D, I, M = 0, 1, 2, 3

NEG_INF = 1 << 30  # reference align.h:18


def align_with_bt(ref: np.ndarray, query: np.ndarray,
                  match_score: int, mismatch_score: int,
                  gap_open: int, gap_extend: int,
                  query_pos: int, ref_pos: int,
                  reverse: bool, first: bool,
                  early_terminate: int) -> list[int]:
    """One-tile DP + traceback.

    Args:
      ref, query: tile byte arrays (raw chars; equality defines a match).
      query_pos, ref_pos: 1-indexed anchor cell for non-first tiles.
    Returns:
      [pos_score, ops...] or, for first tiles, [max_score, max_i, max_j,
      ops...] — the queue layout of align.cpp:185-199.
    """
    ref_len, query_len = len(ref), len(query)

    h_rd = np.zeros(query_len + 1, dtype=np.int64)
    m_rd = np.zeros(query_len + 1, dtype=np.int64)
    i_rd = np.full(query_len + 1, -NEG_INF, dtype=np.int64)
    d_rd = np.full(query_len + 1, -NEG_INF, dtype=np.int64)
    h_wr = h_rd.copy()
    m_wr = m_rd.copy()
    i_wr = i_rd.copy()
    d_wr = d_rd.copy()

    dir_matrix = np.zeros((ref_len + 1, query_len + 1), dtype=np.int64)

    max_score = 0
    pos_score = 0
    max_i = 0
    max_j = 0

    for i in range(1, ref_len + 1):
        m_rd[:] = m_wr
        h_rd[:] = h_wr
        i_rd[:] = i_wr
        d_rd[:] = d_wr

        ref_nt = ref[ref_len - i] if reverse else ref[i - 1]
        for j in range(1, query_len + 1):
            query_nt = query[query_len - j] if reverse else query[j - 1]
            match = match_score if query_nt == ref_nt else mismatch_score

            if m_rd[j - 1] > i_rd[j - 1] and m_rd[j - 1] > d_rd[j - 1]:
                m_wr[j] = m_rd[j - 1] + match
            elif i_rd[j - 1] > d_rd[j - 1]:
                m_wr[j] = i_rd[j - 1] + match
            else:
                m_wr[j] = d_rd[j - 1] + match
            if m_wr[j] < 0:
                m_wr[j] = 0

            ins_open = m_rd[j] + gap_open
            ins_extend = i_rd[j] + gap_extend
            del_open = m_wr[j - 1] + gap_open
            del_extend = d_wr[j - 1] + gap_extend

            i_wr[j] = ins_open if ins_open > ins_extend else ins_extend
            d_wr[j] = del_open if del_open > del_extend else del_extend

            h_wr[j] = max(m_wr[j], i_wr[j], d_wr[j], 0)

            if m_wr[j] >= i_wr[j]:
                op = MATCH_OP if m_wr[j] >= d_wr[j] else DELETE_OP
            else:
                op = INSERT_OP if i_wr[j] >= d_wr[j] else DELETE_OP
            if m_wr[j] <= 0 and i_wr[j] <= 0 and d_wr[j] <= 0:
                op = ZERO_OP
            if ins_open >= ins_extend:
                op += 2 << INSERT_OP
            if del_open >= del_extend:
                op += 2 << DELETE_OP
            if query_nt == ref_nt:
                op += 16  # MATCH_BIT extension, see ops/common.py
            dir_matrix[i, j] = op

            if h_wr[j] >= max_score:
                max_score = h_wr[j]
                max_i = i
                max_j = j

            if i == ref_pos and j == query_pos:
                pos_score = h_wr[j]

    out: list[int] = []
    if first:
        i_curr, j_curr = max_i, max_j
        out += [int(max_score), int(i_curr), int(j_curr)]
    else:
        i_curr, j_curr = ref_pos, query_pos
        out.append(int(pos_score))

    i_steps = 0
    j_steps = 0
    state = int(dir_matrix[i_curr, j_curr]) % 4
    while state != Z:
        if i_steps >= early_terminate or j_steps >= early_terminate:
            break
        out.append(state)
        if state == M:
            state = int(dir_matrix[i_curr - 1, j_curr - 1]) % 4
            i_curr -= 1
            j_curr -= 1
            i_steps += 1
            j_steps += 1
        elif state == I:
            state = M if (dir_matrix[i_curr, j_curr] & (2 << INSERT_OP)) else I
            i_curr -= 1
            i_steps += 1
        elif state == D:
            state = M if (dir_matrix[i_curr, j_curr] & (2 << DELETE_OP)) else D
            j_curr -= 1
            j_steps += 1
    return out
