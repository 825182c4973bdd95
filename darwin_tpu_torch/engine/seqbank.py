"""Flat sequence storage for batched tile slicing and char gathers.

A copy of darwin_tpu/engine/seqbank.py: importing that module would
import jax through darwin_tpu/engine/__init__.py.
"""

from __future__ import annotations

import numpy as np


class SeqBank:
    """A list of byte sequences packed into one flat array."""

    def __init__(self, seqs: list[np.ndarray]):
        self.lengths = np.array([len(s) for s in seqs], dtype=np.int64)
        self.starts = np.zeros(len(seqs), dtype=np.int64)
        if len(seqs):
            np.cumsum(self.lengths[:-1], out=self.starts[1:])
        self.flat = (np.concatenate(seqs) if seqs
                     else np.empty(0, dtype=np.uint8))

    def gather(self, seq_id: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """chars[...] = seq[seq_id][idx]; indices clipped to the flat
        array (callers mask out-of-range columns)."""
        flat_idx = self.starts[seq_id] + idx
        return self.flat[np.clip(flat_idx, 0, max(0, len(self.flat) - 1))]

    def slice(self, seq_id: int, start: int, length: int) -> np.ndarray:
        s = self.starts[seq_id] + start
        return self.flat[s:s + length]

    @classmethod
    def concat(cls, a: "SeqBank", b: "SeqBank") -> "SeqBank":
        """Bank holding a's sequences followed by b's (no copies of the
        per-sequence arrays; flats are concatenated once)."""
        out = cls([])
        out.lengths = np.concatenate([a.lengths, b.lengths])
        out.starts = np.concatenate([a.starts, b.starts + len(a.flat)])
        out.flat = np.concatenate([a.flat, b.flat])
        return out
