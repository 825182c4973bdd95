"""Scalar GACT extension driver: the executable spec for tile stitching.

The port's copy of darwin_tpu/golden/gact.py (numpy only), and the
port's one format_record (engine/batch.py imports it from here).

Transliterates GACT (reference gact.cpp:48-228): from a D-SOFT anchor,
re-anchor on the first tile's max cell, gate on
first_tile_score_threshold, extend left then right in overlapping tiles,
rescore the stitched alignment with the affine rule, and emit one
overlap record.  Parity-critical details:

* Left extension aligns forward tiles ending at the anchor
  (reverse=False); right extension aligns reversed tiles starting at it
  (reverse=True) so traceback ops come out in forward order
  (gact.cpp:87-94, 149-156).
* The first tile stays "first" until a tile produces at least one op
  (first_tile cleared inside the op loop, gact.cpp:112, 173).
* A failed first-tile threshold breaks the left loop but the right loop
  still runs its own first tile (gact.cpp:107-109, 144).
* The final score is recomputed from the aligned strings; a gap in
  either string keeps open=False for the next column (gact.cpp:197-210).
* Records are suppressed for same-file self hits and score <=
  SCORE_THRESHOLD == 0 (gact.cpp:213).
"""

from __future__ import annotations

import numpy as np

from darwin_tpu_torch.golden.align import D, I, M, align_with_bt

SCORE_THRESHOLD = 0  # reference gact.cpp:24
GAP = 255  # sentinel byte for '-' in aligned arrays


def affine_rescore(aligned_ref: list[int], aligned_query: list[int],
                   match_score: int, mismatch_score: int,
                   gap_open: int, gap_extend: int) -> int:
    """Recompute the total score (reference gact.cpp:197-210)."""
    total = 0
    open_ = True
    for r, q in zip(aligned_ref, aligned_query):
        if r == GAP or q == GAP:
            total += gap_open if open_ else gap_extend
            open_ = False
        else:
            total += match_score if r == q else mismatch_score
            open_ = True
    return total


def gact_scalar(ref: np.ndarray, query: np.ndarray,
                tile_size: int, tile_overlap: int,
                ref_pos: int, query_pos: int,
                first_tile_score_threshold: int,
                match_score: int, mismatch_score: int,
                gap_open: int, gap_extend: int,
                ) -> tuple[int, int, int, int, int]:
    """One GACT call.  Returns (ab, ae, bb, be, total_score)."""
    ref_length, query_length = len(ref), len(query)
    early_terminate = tile_size - tile_overlap

    aligned_ref: list[int] = []
    aligned_query: list[int] = []

    rev_ref_pos = ref_pos
    rev_query_pos = query_pos
    i = 0
    j = 0
    first_tile = True

    # Left extension (towards position 0), gact.cpp:82-134.
    while ref_pos > 0 and query_pos > 0 and ((i > 0 and j > 0)
                                             or first_tile):
        ref_tile_length = min(ref_pos, tile_size)
        query_tile_length = min(query_pos, tile_size)
        bt = align_with_bt(
            ref[ref_pos - ref_tile_length: ref_pos],
            query[query_pos - query_tile_length: query_pos],
            match_score, mismatch_score, gap_open, gap_extend,
            query_tile_length, ref_tile_length, False,
            first_tile, early_terminate)
        i = 0
        j = 0
        tile_score = bt[0]
        k = 1
        if first_tile:
            ref_pos = ref_pos - ref_tile_length + bt[1]
            query_pos = query_pos - query_tile_length + bt[2]
            k = 3
            rev_ref_pos = ref_pos
            rev_query_pos = query_pos
            if tile_score < first_tile_score_threshold:
                break
        prepend_r: list[int] = []
        prepend_q: list[int] = []
        for state in bt[k:]:
            first_tile = False
            if state == M:
                prepend_r.append(int(ref[ref_pos - j - 1]))
                prepend_q.append(int(query[query_pos - i - 1]))
                i += 1
                j += 1
            elif state == I:
                prepend_r.append(int(ref[ref_pos - j - 1]))
                prepend_q.append(GAP)
                j += 1
            elif state == D:
                prepend_r.append(GAP)
                prepend_q.append(int(query[query_pos - i - 1]))
                i += 1
        # Ops arrive right-to-left; inserting each at the front of the
        # aligned strings (gact.cpp:116-128) equals prepending the
        # reversed arrival list.
        aligned_ref[:0] = prepend_r[::-1]
        aligned_query[:0] = prepend_q[::-1]
        ref_pos -= j
        query_pos -= i

    abpos = ref_pos
    bbpos = query_pos
    ref_pos = rev_ref_pos
    query_pos = rev_query_pos
    i = tile_size
    j = tile_size

    # Right extension (towards the ends), gact.cpp:144-195.
    while (ref_pos < ref_length and query_pos < query_length
           and ((i > 0 and j > 0) or first_tile)):
        ref_tile_length = min(tile_size, ref_length - ref_pos)
        query_tile_length = min(tile_size, query_length - query_pos)
        bt = align_with_bt(
            ref[ref_pos: ref_pos + ref_tile_length],
            query[query_pos: query_pos + query_tile_length],
            match_score, mismatch_score, gap_open, gap_extend,
            query_tile_length, ref_tile_length, True,
            first_tile, early_terminate)
        i = 0
        j = 0
        tile_score = bt[0]
        k = 1
        if first_tile:
            ref_pos = ref_pos + ref_tile_length - bt[1]
            query_pos = query_pos + query_tile_length - bt[2]
            k = 3
            if tile_score < first_tile_score_threshold:
                break
        for state in bt[k:]:
            first_tile = False
            if state == M:
                aligned_ref.append(int(ref[ref_pos + j]))
                aligned_query.append(int(query[query_pos + i]))
                i += 1
                j += 1
            elif state == I:
                aligned_ref.append(int(ref[ref_pos + j]))
                aligned_query.append(GAP)
                j += 1
            elif state == D:
                aligned_ref.append(GAP)
                aligned_query.append(int(query[query_pos + i]))
                i += 1
        ref_pos += j
        query_pos += i

    total_score = affine_rescore(aligned_ref, aligned_query, match_score,
                                 mismatch_score, gap_open, gap_extend)
    return abpos, ref_pos, bbpos, query_pos, total_score


def format_record(ref_name: str, query_name: str, ab: int, ae: int,
                  bb: int, be: int, score: int, comp: bool) -> str:
    """Overlap record line (reference gact.cpp:213-224)."""
    return (f"ref_id: {ref_name}, query_id: {query_name}, "
            f"ab: {ab}, ae: {ae}, bb: {bb}, be: {be}, "
            f"score: {score}, comp: {1 if comp else 0}")
