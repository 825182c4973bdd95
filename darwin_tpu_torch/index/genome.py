"""Reference-genome assembly: concatenation, bin padding, bin->chr maps.

The port's copy of darwin_tpu/index/genome.py.  Mirrors the reference
driver's genome layout (darwin.cpp:530-546): all reference pieces are
concatenated into one string, each piece padded with 'N' to a multiple
of bin_size, and two maps are kept: chr_id_to_start_bin and
bin_to_chr_id.  D-SOFT hits are global positions in the padded
concatenation; they decode to (chr_id, chromosome-local position)
through the bin maps (darwin.cpp:216-223), clamping local positions to
the piece length.
"""

from __future__ import annotations

import numpy as np

from darwin_tpu_torch.coding import seq_to_bytes
from darwin_tpu_torch.io.fasta import FastaRecord


class Genome:
    def __init__(self, records: list[FastaRecord], bin_size: int):
        self.bin_size = bin_size
        self.names = [r.name for r in records]
        self.piece_lengths = np.array([len(r.seq) for r in records],
                                      dtype=np.int64)
        self.piece_bytes = [seq_to_bytes(r.seq) for r in records]

        chunks: list[np.ndarray] = []
        start_bins: list[int] = []
        bin_to_chr: list[int] = []
        curr_bin = 0
        pad_byte = np.uint8(ord("N"))
        for i, b in enumerate(self.piece_bytes):
            start_bins.append(curr_bin)
            chunks.append(b)
            nfull, rem = divmod(len(b), bin_size)
            bin_to_chr.extend([i] * nfull)
            curr_bin += nfull
            if rem:
                chunks.append(np.full(bin_size - rem, pad_byte))
                bin_to_chr.append(i)
                curr_bin += 1
        self.concat = (np.concatenate(chunks) if chunks
                       else np.empty(0, dtype=np.uint8))
        self.chr_id_to_start_bin = np.array(start_bins, dtype=np.int64)
        self.bin_to_chr_id = np.array(bin_to_chr, dtype=np.int64)

    @property
    def total_length(self) -> int:
        return len(self.concat)

    def decode_hits(self, hits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global hit positions -> (chr_id, clamped local position)."""
        hits = np.asarray(hits, dtype=np.int64)
        chr_id = self.bin_to_chr_id[hits // self.bin_size]
        local = hits - self.chr_id_to_start_bin[chr_id] * self.bin_size
        local = np.minimum(local, self.piece_lengths[chr_id])
        return chr_id, local
