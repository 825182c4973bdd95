"""The plane-2 emitter: the packed6 tile DP plus a second word plane.

The port of tools/plane2_probe.py's kernel (the pallas_call `plane2` at
line 209, kernel body kernel2 at :146-196), which prices a walker that
would read deeper diagonal cells from a second int32 plane.  The kernel
is the plane-2 variant of the tile DP (ops/dp.py picks it: csrc/dp.cu's
one-warp or int32 split kernel, or csrc/dp16.cu's 16-bit split kernel
past T = 1023 where its gate passes), and emits in one pass

* dir_words: the packed6 words (ops/pack.py::pack_dir_words6),
* dir2_words: P[r, c] = D[r-4, c-2] | D[r-5, c-2] << 5 | D[r-6, c-3] << 10
  (ops/pack.py::plane2_words),
* max_score, max_i, max_j, pos_score as align_tiles does,

all [B, T, T+1] / [B].  Unlike the probe, which fixes both lengths at
T, it takes general ref_len / query_len.  A CPU tensor runs the plain
version (align_tiles_torch, then the two packers); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import types

import torch

from darwin_tpu_torch.ops.dp import ONE_WARP, SPLIT, SPLIT16, run_kernel
from darwin_tpu_torch.ops.pack import pack_dir_words6, plane2_words
from darwin_tpu_torch.ops.reference_dp import align_tiles_torch


def plane2_torch(ref: torch.Tensor, query: torch.Tensor,
                 ref_len: torch.Tensor, query_len: torch.Tensor,
                 **scoring) -> dict:
    """The plain version: the byte DP, then both planes packed."""
    out = align_tiles_torch(ref, query, ref_len, query_len, **scoring)
    d = out.pop("dir")
    out["dir_words"] = pack_dir_words6(d)
    out["dir2_words"] = plane2_words(d)
    return out


def plane2(ref: torch.Tensor, query: torch.Tensor, ref_len: torch.Tensor,
           query_len: torch.Tensor, *, match: int, mismatch: int,
           gap_open: int, gap_extend: int) -> dict:
    """ref/query [B, T] uint8, ref_len/query_len [B] int32 ->
    dict(dir_words, dir2_words [B, T, T+1] int32, max_score, max_i,
    max_j, pos_score [B] int32)."""
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if ref.device.type == "cpu":
        return plane2_torch(ref, query, ref_len, query_len, **kw)
    out, kernel = run_kernel(ref, query, ref_len, query_len, fmt="plane2",
                             interleave=1, what="plane2", **kw)
    if ref.shape[0]:
        COUNTERS[kernel].launches += 1
    out["dir_words"] = out.pop("dir")
    out["dir2_words"] = out.pop("dir2")
    return out


# Launches of the one-warp kernel; plane2.split counts the int32 split
# kernel's, plane2.split16 the 16-bit split kernel's.
plane2.launches = 0
plane2.split = types.SimpleNamespace(launches=0)
plane2.split16 = types.SimpleNamespace(launches=0)
COUNTERS = {ONE_WARP: plane2, SPLIT: plane2.split, SPLIT16: plane2.split16}
