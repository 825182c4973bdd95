"""Nucleotide coding: 2-bit packing, Wang hash, minimizer scan.

The port's copy of darwin_tpu/coding/ntcoding.py.  Vectorized NumPy
implementations with bit-exact parity to the reference
(ntcoding.cpp:56-182).  Parity-sensitive details preserved:

* 2-bit code: A=0, C=1, G=2, T=3; N and every other char pack to 0
  (ntcoding.cpp:56-69).  Lowercase packs like uppercase.
* Sequences pack 16 bases per uint32 word, little-endian within the
  word; the word array has ``1 + len//16`` entries so a k-mer read can
  always touch word ``idx+1`` (ntcoding.cpp:87-103,115-124).
* The minimizer scan runs over positions ``w-1 <= p < 16*s_len - k - w``
  where ``s_len`` is a *word* count chosen by the caller — the reference
  passes ``1 + len//16`` for the reference genome (seed_pos_table.cpp:60)
  but ``ceil(len/16)`` for queries (seed_pos_table.cpp:108), so the scan
  range deliberately covers zero-padding ("A" bases) at the tail.  We
  replicate both conventions exactly.
* Emission rule: emit (min-hash, p) whenever the window minimum changed
  or the last emission is >= w positions old (ntcoding.cpp:139-147),
  with last_m = last_p = 0 initially.
"""

from __future__ import annotations

import numpy as np

_TWOBIT_LUT = np.zeros(256, dtype=np.uint32)
for _c, _v in (("a", 0), ("A", 0), ("c", 1), ("C", 1),
               ("g", 2), ("G", 2), ("t", 3), ("T", 3)):
    _TWOBIT_LUT[ord(_c)] = _v


def seq_to_bytes(seq: str) -> np.ndarray:
    """Raw ASCII bytes of a sequence (uint8).

    The alignment kernels compare raw bytes so that the reference's
    char-equality match rule holds exactly (align.cpp:134): N matches N,
    lowercase differs from uppercase, etc.
    """
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)


def seq_to_twobit_words(seq: str | np.ndarray) -> np.ndarray:
    """Pack a sequence into uint32 words, 16 bases each, plus one pad word.

    Mirrors SeqToTwoBit (ntcoding.cpp:87-103): output length is
    ``1 + len//16``; unused high bases in the last words are zero.
    """
    b = seq_to_bytes(seq) if isinstance(seq, str) else seq
    n = len(b)
    codes = _TWOBIT_LUT[b]  # uint32
    nwords = 1 + n // 16
    padded = np.zeros(nwords * 16, dtype=np.uint32)
    padded[:n] = codes
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return (padded.reshape(nwords, 16) << shifts).sum(
        axis=1, dtype=np.uint32)


def hash32(key: np.ndarray, k: int) -> np.ndarray:
    """Thomas Wang 32-bit integer hash masked to 2k bits (ntcoding.cpp:74-85)."""
    key = key.astype(np.uint32, copy=True)
    m = np.uint32((1 << (2 * k)) - 1)
    key = (~key + (key << np.uint32(21))) & m
    key = key ^ (key >> np.uint32(24))
    key = ((key + (key << np.uint32(3))) + (key << np.uint32(8))) & m
    key = key ^ (key >> np.uint32(14))
    key = ((key + (key << np.uint32(2))) + (key << np.uint32(4))) & m
    key = key ^ (key >> np.uint32(28))
    key = (key + (key << np.uint32(31))) & m
    return key


def seeds_at_positions(words: np.ndarray, pos: np.ndarray, k: int
                       ) -> np.ndarray:
    """k-mer codes at arbitrary base offsets (GetSeedAtPos, ntcoding.cpp:115-124)."""
    idx = pos // 16
    shift = (pos % 16).astype(np.uint64)
    lo = words[idx].astype(np.uint64)
    hi = words[idx + 1].astype(np.uint64)
    concat = (hi << np.uint64(32)) | lo
    mask = np.uint64((1 << (2 * k)) - 1)
    return ((concat >> (np.uint64(2) * shift)) & mask).astype(np.uint32)


def _sliding_min(h: np.ndarray, w: int) -> np.ndarray:
    """out[i] = min(h[i], h[i+1], ..., h[i+w-1]) for i in [0, len-w]."""
    out = h[: len(h) - w + 1].copy()
    for s in range(1, w):
        np.minimum(out, h[s: s + len(out)], out=out)
    return out


def minimizer_scan(words: np.ndarray, s_len: int, k: int, w: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Window-minimizer scan (TwoBitToMinimizers, ntcoding.cpp:126-153).

    Args:
      words: packed 2-bit words (``seq_to_twobit_words`` output).
      s_len: the *word count* defining the scan range — callers pass the
        reference's convention (see module docstring).
    Returns:
      (positions p, minimizer hash m at p) for every emitted minimizer,
      in scan order.

    Vectorization note: the reference's sequential emit rule
    (ntcoding.cpp:142-146) is equivalent to: the window minimum is
    piecewise constant; every change point emits, and within a constant
    run anchored at its last emission, every w-th position emits.  The
    initial run is anchored at the virtual emission (p=0, m=0).
    """
    hi = 16 * s_len - k - w  # exclusive upper bound on p
    lo = w - 1
    if hi <= lo:
        return (np.empty(0, dtype=np.uint32), np.empty(0, dtype=np.uint32))

    # Window hashes cover positions [lo - (w-1), hi) = [0, hi).
    pos_all = np.arange(0, hi, dtype=np.int64)
    h = hash32(seeds_at_positions(words, pos_all, k), k)
    # m[i] = min over window ending at p = lo + i, i in [0, hi-lo)
    m = _sliding_min(h, w)
    p = np.arange(lo, hi, dtype=np.int64)

    # Change points relative to the previous minimum; position lo
    # compares against the initial last_m = 0.
    prev = np.empty_like(m)
    prev[0] = 0
    prev[1:] = m[:-1]
    change = m != prev

    # Anchor of each constant run: the change point position, or the
    # virtual p=0 for the initial run if it did not change.
    run_id = np.cumsum(change)
    anchors = np.zeros(run_id[-1] + 1, dtype=np.int64)
    anchors[run_id[change]] = p[change]
    offset = p - anchors[run_id]
    emit = change | (offset % w == 0) & (offset > 0)
    # The virtual anchor (run_id 0, anchor 0) emits whenever p % w == 0
    # including the degenerate offset==p case handled above; but offset
    # for run 0 equals p which is >= lo >= 1, so the mask is right.
    return p[emit].astype(np.uint32), m[emit].astype(np.uint32)


def ref_minimizers(seq: str | np.ndarray, k: int, w: int) -> np.ndarray:
    """Reference-sequence minimizers as (hash << 32) | pos, scan order.

    Uses the reference-genome word-count convention s_len = 1 + len//16
    (seed_pos_table.cpp:60-66).
    """
    b = seq_to_bytes(seq) if isinstance(seq, str) else seq
    words = seq_to_twobit_words(b)
    s_len = 1 + len(b) // 16
    # The scan may read words[idx+1] for idx up to (16*s_len-k-w-1)//16;
    # with k + w >= 17 this stays within the allocated array, like the
    # reference.  Guard anyway for small k+w.
    need = (16 * s_len - k - w - 1) // 16 + 2 if 16 * s_len > k + w else 0
    if need > len(words):
        words = np.concatenate(
            [words, np.zeros(need - len(words), dtype=np.uint32)])
    p, m = minimizer_scan(words, s_len, k, w)
    return (m.astype(np.uint64) << np.uint64(32)) | p.astype(np.uint64)


def query_minimizers(seq: str | np.ndarray, k: int, w: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Query minimizers as (offset, hash) arrays in scan order.

    Uses the query word-count convention s_len = ceil(len/16)
    (seed_pos_table.cpp:108-114, QTwoBitToMinimizers).
    """
    b = seq_to_bytes(seq) if isinstance(seq, str) else seq
    words = seq_to_twobit_words(b)
    s_len = (len(b) + 15) // 16
    need = (16 * s_len - k - w - 1) // 16 + 2 if 16 * s_len > k + w else 0
    if need > len(words):
        words = np.concatenate(
            [words, np.zeros(need - len(words), dtype=np.uint32)])
    return minimizer_scan(words, s_len, k, w)
