"""Production seed-position index.

The port's copy of darwin_tpu/index/seed_table.py, built with the port's
own native library (darwin_tpu_torch/native.py).  Re-design of
SeedPosTable (reference seed_pos_table.cpp:46-98):

* The reference materializes a dense 4^k+1 CSR index table (1 GiB at
  k=14); this keeps the hash-sorted minimizer arrays and uses binary
  search (searchsorted) for range lookups -- identical (start, end)
  ranges, two orders of magnitude less memory.
* The sort order (hash, then position) matches the reference's uint64
  sort of (hash << 32) | pos.

The table is persistable (the reference rebuilds it every run).  On a
CUDA device it is built there (index/table_device.py: csrc/seed_table.cu's
scan and sort).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from darwin_tpu_torch import native
from darwin_tpu_torch.coding import ref_minimizers, seq_to_bytes
from darwin_tpu_torch.index import table_device

_FORMAT_VERSION = 1


class SeedTable:
    def __init__(self, hashes: np.ndarray, pos: np.ndarray, *,
                 kmer_size: int, window_size: int, bin_size: int,
                 ref_size: int, kmer_max_occurence: int):
        self.hashes = hashes            # uint32, sorted
        self.pos = pos                  # uint32, grouped by hash, ascending
        self.k = kmer_size
        self.w = window_size
        self.bin_size = bin_size
        self.ref_size = ref_size
        self.kmer_max_occurence = kmer_max_occurence

    @classmethod
    def build(cls, ref_seq: str | np.ndarray, kmer_size: int,
              seed_occurence_multiple: int, bin_size: int,
              window_size: int, device: torch.device | str | None = None
              ) -> "SeedTable":
        """Sorted (hash << 32) | pos minimizer keys, minus the keys at
        padding positions >= ref_size.

        On a CUDA device the kernels of table_device build them there;
        with no device, or the CPU, the native library's parallel scan
        and sort, or NumPy without it."""
        if not 3 < kmer_size <= 15:
            raise ValueError(f"seed size {kmer_size}: need 3 < k <= 15 "
                             f"(seed_pos_table.cpp:48)")
        if not kmer_size > window_size:
            raise ValueError(f"seed size {kmer_size} <= window "
                             f"{window_size} (seed_pos_table.cpp:50)")
        ref_size = len(ref_seq)
        kmer_max_occurence = seed_occurence_multiple * (
            1 + (ref_size >> (2 * kmer_size)))
        kw = dict(kmer_size=kmer_size, window_size=window_size,
                  bin_size=bin_size, ref_size=ref_size,
                  kmer_max_occurence=kmer_max_occurence)
        b = seq_to_bytes(ref_seq) if isinstance(ref_seq, str) else ref_seq
        if device is not None and torch.device(device).type == "cuda":
            return cls(*table_device.table_arrays(b, kmer_size, window_size,
                                                  device), **kw)
        if native.available():
            keys = native.build_table_keys(b, kmer_size, window_size)
        else:
            keys = np.sort(ref_minimizers(ref_seq, kmer_size, window_size))
        # For k + w < 16 the reference-convention scan range
        # 16*(1 + len//16) - k - w extends past the reference end, so
        # padding positions enter the table; the reference then indexes
        # its bin->chromosome map out of bounds on such hits
        # (darwin.cpp:216-223, UB).  Sane semantics: drop them (no
        # observable difference for the default k=14, w=4).
        keys = keys[(keys & np.uint64(0xFFFFFFFF)) < ref_size]
        return cls(
            (keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32), **kw)

    def lookup(self, h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized (start, end) pos-table ranges for hash values."""
        start = np.searchsorted(self.hashes, h, side="left")
        end = np.searchsorted(self.hashes, h, side="right")
        return start, end

    # -- persistence ---------------------------------------------------
    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            path, version=_FORMAT_VERSION, hashes=self.hashes,
            pos=self.pos, k=self.k, w=self.w, bin_size=self.bin_size,
            ref_size=self.ref_size,
            kmer_max_occurence=self.kmer_max_occurence)

    @classmethod
    def load(cls, path: str | Path) -> "SeedTable":
        z = np.load(path)
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(f"unsupported seed table version {z['version']}")
        return cls(z["hashes"], z["pos"], kmer_size=int(z["k"]),
                   window_size=int(z["w"]), bin_size=int(z["bin_size"]),
                   ref_size=int(z["ref_size"]),
                   kmer_max_occurence=int(z["kmer_max_occurence"]))
