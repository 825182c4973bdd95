"""Scalar D-SOFT: the executable spec for seed filtration.

The port's copy of darwin_tpu/golden/dsoft.py (numpy only).

Transliterates the SeedPosTable constructor (seed_pos_table.cpp:46-98)
and the DSOFT query loop (seed_pos_table.cpp:100-167).  Parity-critical
details:

* kmer_max_occurence = multiple * (1 + (ref_len >> 2k))
  (seed_pos_table.cpp:58).
* Minimizers sorted as (hash << 32) | pos uint64s, i.e. by hash then
  position (seed_pos_table.cpp:71).
* The bin counter adds k for a fresh/non-overlapping seed and
  offset-delta for an overlapping one (seed_pos_table.cpp:140); a bin
  freezes once its count reaches threshold (gate at :139) and emits
  exactly one candidate at the crossing (:142-149).
* num_seeds cap: a minimizer passing the occurrence filter is processed
  iff the count of previously processed passing minimizers is <= N
  (check-before-increment at :128-131) — i.e. the first N+1 pass.
* max_candidates cap breaks the current minimizer's hit loop after the
  count update but before emission (:145-147).
"""

from __future__ import annotations

import numpy as np

from darwin_tpu_torch.coding import query_minimizers, ref_minimizers


class GoldenSeedTable:
    """Sorted-minimizer seed index (CSR semantics via searchsorted)."""

    def __init__(self, ref_seq: str | np.ndarray, kmer_size: int,
                 seed_occurence_multiple: int, bin_size: int,
                 window_size: int):
        assert 3 < kmer_size <= 15
        assert kmer_size > window_size
        self.k = kmer_size
        self.w = window_size
        self.bin_size = bin_size
        self.ref_size = len(ref_seq)
        self.kmer_max_occurence = seed_occurence_multiple * (
            1 + (self.ref_size >> (2 * kmer_size)))

        minimizers = np.sort(ref_minimizers(ref_seq, self.k, self.w))
        # Positions past the reference end (possible when k + w < 16,
        # see index/seed_table.py) would be out-of-bounds UB in the
        # reference's bin decode; excluded by design.
        minimizers = minimizers[
            (minimizers & np.uint64(0xFFFFFFFF)) < self.ref_size]
        self.hashes = (minimizers >> np.uint64(32)).astype(np.uint32)
        self.pos_table = (minimizers & np.uint64(0xFFFFFFFF)).astype(
            np.uint32)

    def lookup(self, h: int | np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(start, end) ranges into pos_table for hash value(s) h."""
        start = np.searchsorted(self.hashes, h, side="left")
        end = np.searchsorted(self.hashes, h, side="right")
        return start, end


def dsoft_scalar(table: GoldenSeedTable, query: str | np.ndarray,
                 num_seeds_cap: int, threshold: int,
                 max_candidates: int) -> list[tuple[int, int]]:
    """Sequential D-SOFT; returns [(hit, offset), ...] in emission order."""
    offs, hashes = query_minimizers(query, table.k, table.w)
    bin_state: dict[int, tuple[int, int]] = {}  # bin -> (count, last_offset)
    candidates: list[tuple[int, int]] = []
    num_seeds = 0

    for offset, h in zip(offs.tolist(), hashes.tolist()):
        start, end = table.lookup(h)
        start, end = int(start), int(end)
        if end - start > table.kmer_max_occurence:
            continue
        if num_seeds > num_seeds_cap:
            break
        num_seeds += 1
        for j in range(start, end):
            hit = int(table.pos_table[j])
            assert hit < table.ref_size
            if hit < offset:
                continue
            b = (hit - offset) // table.bin_size
            curr_count, last_offset = bin_state.get(b, (0, 0))
            if curr_count < threshold:
                if offset - last_offset > table.k or curr_count == 0:
                    new_count = curr_count + table.k
                else:
                    new_count = curr_count + (offset - last_offset)
                bin_state[b] = (new_count, offset)
                if new_count >= threshold:
                    if len(candidates) >= max_candidates:
                        break
                    candidates.append((hit, offset))
    return candidates
