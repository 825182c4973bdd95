"""Tile-batch aligner of the host-stepped engine: one call = DP + walk on
the device, results back as NumPy.

The port of darwin_tpu/engine/aligner.py::JaxTileAligner: the tile DP
in the packed6 word format (ops/dp.py, the K1 kernel) and the packed6
walker (ops/traceback.py::traceback_packed6), on `device`.  The Pallas
grid's batch padding is not carried over (the CUDA kernels take any
batch).  tile_size, when given, is checked against the CUDA DP
kernel's limit on a CUDA device (the tiles carry their size).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from darwin_tpu_torch.ops.dp import align_tiles, check_tile_size
from darwin_tpu_torch.ops.traceback import traceback_packed6


@dataclasses.dataclass
class TileResult:
    ops: np.ndarray        # [B, S] uint8, arrival order, 0 = none
    ref_steps: np.ndarray  # [B] int32 (kernel i_steps)
    query_steps: np.ndarray  # [B] int32 (kernel j_steps)
    score: np.ndarray      # [B] int32: max score (first) / corner score
    max_i: np.ndarray      # [B] int32 (1-indexed, first tiles only)
    max_j: np.ndarray      # [B] int32


class TorchTileAligner:
    def __init__(self, *, early_terminate: int, match: int, mismatch: int,
                 gap_open: int, gap_extend: int,
                 device: torch.device | str, tile_size: int | None = None):
        if tile_size is not None and torch.device(device).type == "cuda":
            check_tile_size(tile_size, "TorchTileAligner")
        self.early_terminate = early_terminate
        self.scoring = dict(match=match, mismatch=mismatch,
                            gap_open=gap_open, gap_extend=gap_extend)
        self.device = torch.device(device)
        self.calls = 0  # batches aligned (host engine iterations)

    def __call__(self, ref_tiles: np.ndarray, query_tiles: np.ndarray,
                 ref_lens: np.ndarray, query_lens: np.ndarray,
                 firsts: np.ndarray) -> TileResult:
        def up(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(
                self.device)

        out = tile_step(up(ref_tiles, np.uint8), up(query_tiles, np.uint8),
                        up(ref_lens, np.int32), up(query_lens, np.int32),
                        up(firsts, bool), early_terminate=self.early_terminate,
                        **self.scoring)
        self.calls += 1
        stats = torch.stack(out[1:]).cpu().numpy()
        return TileResult(out[0].cpu().numpy(), *stats)


def tile_step(ref, query, rlen, qlen, first, *, early_terminate: int,
              match: int, mismatch: int, gap_open: int, gap_extend: int):
    """One batch of tiles on their device: the packed6 DP and the packed6
    walker.  Returns (ops [B, S] uint8 in arrival order, 0 = none;
    i_steps, j_steps, score (the max cell's on first tiles, else the
    corner's), max_i, max_j), each [B] int32."""
    out = align_tiles(ref, query, rlen, qlen, dir_format="packed6",
                      match=match, mismatch=mismatch, gap_open=gap_open,
                      gap_extend=gap_extend)
    raw, i_steps, j_steps = traceback_packed6(
        out["dir_words"], rlen, qlen, first, out["max_i"], out["max_j"],
        early_terminate=early_terminate)
    score = torch.where(first, out["max_score"], out["pos_score"])
    return raw & 3, i_steps, j_steps, score, out["max_i"], out["max_j"]
