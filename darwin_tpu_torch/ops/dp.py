"""GACT tile DP: the CUDA kernel csrc/dp.cu and its dispatch.

The port of darwin_tpu/ops/pallas_dp.py::align_tiles_pallas.  It
emits dir BYTES [B, T, T+1] (the traceback walker reads bytes; the
TPU's packed words and 128-lane column padding are not carried over).
A CPU tensor runs the plain version, reference_dp.align_tiles_torch; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from darwin_tpu_torch import _build
from darwin_tpu_torch.ops.reference_dp import align_tiles_torch

# One thread per DP column (T + 1 of them) in one block.
MAX_TILE = 1023


def align_tiles(ref: torch.Tensor, query: torch.Tensor,
                ref_len: torch.Tensor, query_len: torch.Tensor, *,
                match: int, mismatch: int, gap_open: int,
                gap_extend: int) -> dict:
    """Same contract as align_tiles_torch: ref/query [B, T] uint8,
    ref_len/query_len [B] int32 -> dict(dir [B, T, T+1] uint8,
    max_score, max_i, max_j, pos_score [B] int32)."""
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if ref.device.type == "cpu":
        return align_tiles_torch(ref, query, ref_len, query_len, **kw)
    dev = _build.require_cuda(ref, "align_tiles")
    B, T = ref.shape
    if not 1 <= T <= MAX_TILE:
        raise ValueError(f"align_tiles: tile size {T} outside "
                         f"1..{MAX_TILE}")
    u8, i32 = torch.uint8, torch.int32
    args = [_build.arg(ref, "ref", u8, (B, T), dev),
            _build.arg(query, "query", u8, (B, T), dev),
            _build.arg(ref_len, "ref_len", i32, (B,), dev),
            _build.arg(query_len, "query_len", i32, (B,), dev)]
    out = dict(dir=torch.empty((B, T, T + 1), dtype=u8, device=dev))
    for k in ("max_score", "max_i", "max_j", "pos_score"):
        out[k] = torch.empty(B, dtype=i32, device=dev)
    if B:
        _build.launch(
            "dtt_align_tiles", dev, *args, B, T, match, mismatch,
            gap_open, gap_extend, out["dir"].data_ptr(),
            out["max_score"].data_ptr(), out["max_i"].data_ptr(),
            out["max_j"].data_ptr(), out["pos_score"].data_ptr())
        align_tiles.launches += 1
    return out


align_tiles.launches = 0
