"""Vectorized D-SOFT candidate filtration, on the host.

The port's copy of darwin_tpu/dsoft/filter.py: what collect_calls runs
per read when the native library is not built.  Re-design of the
sequential DSOFT loop (reference seed_pos_table.cpp:100-167) as a
data-parallel pipeline.  The key observation: the per-bin counter update

    new_count = (offset - last_offset > k or count == 0)
                ? count + k : count + (offset - last_offset)

depends only on the sequence of (offset) values hitting that bin, and
query-minimizer offsets are non-decreasing in tuple order, so for the
t-th tuple of a bin

    count_t = k + sum_{s<=t, s>0} min(k, offset_s - offset_{s-1})

i.e. a segmented prefix sum after a stable sort by bin.  A bin emits
exactly one candidate at its first threshold crossing (the reference
freezes the bin afterwards via the curr_count < threshold gate at
:139), so the emitted tuple is the first one whose prefix sum reaches
the threshold.

Caps replicated:
* num_seeds: only the first N+1 minimizers passing the occurrence
  filter are processed (check-before-increment at :128-131).
* max_candidates: emissions truncated in original tuple order.  (The
  reference additionally stops counting the remaining hits of the
  minimizer that hits the cap — unobservable unless the cap actually
  triggers, which the defaults make unreachable; the golden scalar
  keeps the exact loop.)
"""

from __future__ import annotations

import numpy as np

from darwin_tpu_torch.coding import query_minimizers
from darwin_tpu_torch.index.seed_table import SeedTable


def dsoft(table: SeedTable, query: str | np.ndarray, num_seeds_cap: int,
          threshold: int, max_candidates: int
          ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (hits, offsets) of candidates in emission order."""
    empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    offs, hashes = query_minimizers(query, table.k, table.w)
    if len(offs) == 0:
        return empty

    start, end = table.lookup(hashes)
    counts = end - start
    passing = counts <= table.kmer_max_occurence
    rank = np.cumsum(passing)
    keep = passing & (rank <= num_seeds_cap + 1)
    midx = np.flatnonzero(keep)
    if len(midx) == 0:
        return empty

    # Expand every kept minimizer into its (hit, offset) tuples, in
    # tuple order: minimizer order, then position order within a hash
    # (pos_table is (hash, pos)-sorted, matching the reference scan).
    s = start[midx].astype(np.int64)
    n = counts[midx].astype(np.int64)
    total = int(n.sum())
    if total == 0:
        return empty
    rep = np.repeat(np.arange(len(midx)), n)
    run_start = np.concatenate(([0], np.cumsum(n)[:-1]))
    within = np.arange(total) - run_start[rep]
    hit = table.pos[s[rep] + within].astype(np.int64)
    offset = offs[midx][rep].astype(np.int64)

    valid = hit >= offset  # seed_pos_table.cpp:135
    hit, offset = hit[valid], offset[valid]
    orig = np.flatnonzero(valid)
    if len(hit) == 0:
        return empty

    bins = (hit - offset) // table.bin_size
    order = np.argsort(bins, kind="stable")
    b_s, h_s, o_s, orig_s = bins[order], hit[order], offset[order], orig[order]

    seg_start = np.empty(len(b_s), dtype=bool)
    seg_start[0] = True
    seg_start[1:] = b_s[1:] != b_s[:-1]

    delta = np.empty_like(o_s)
    delta[0] = 0
    delta[1:] = o_s[1:] - o_s[:-1]
    inc = np.where(seg_start, table.k, np.minimum(delta, table.k))

    cum = np.cumsum(inc)
    seg_id = np.cumsum(seg_start) - 1
    seg_base = (cum - inc)[seg_start]  # prefix total before each segment
    count = cum - seg_base[seg_id]

    crossing = count >= threshold
    prev_cross = np.empty_like(crossing)
    prev_cross[0] = False
    prev_cross[1:] = crossing[:-1]
    first_cross = crossing & ~(prev_cross & ~seg_start)

    emit_orig = orig_s[first_cross]
    emit_hit = h_s[first_cross]
    emit_off = o_s[first_cross]
    eorder = np.argsort(emit_orig, kind="stable")[:max_candidates]
    return emit_hit[eorder], emit_off[eorder]
