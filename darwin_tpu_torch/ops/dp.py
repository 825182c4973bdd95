"""GACT tile DP: the CUDA kernel csrc/dp.cu and its dispatch.

The port of darwin_tpu/ops/pallas_dp.py::align_tiles_pallas, in its
three dir formats and its interleaved form.  The TPU's 128-lane column
padding is not carried over: every direction output is [B, T, T+1].

* dir_format "bytes" (the main path's: the traceback walker reads
  bytes) returns ``dir`` uint8; "packed" and "packed6" return
  ``dir_words`` int32 in the layouts of pack_dir_words /
  pack_dir_words6 (ops/pack.py), written fused by the kernel.
* interleave N in {1, 2, 4} puts N tiles in one warp, stepping
  together with their instructions interleaved (the Hopper form of the
  TPU kernel's N batch streams); the results are bit-identical for
  every N.  B must divide by N.
* align_tiles_pallas's ``block_b`` is not ported: it is a Mosaic block
  shape, and here a warp always holds whole tiles.

A CPU tensor runs the plain version, align_tiles_plain
(reference_dp.align_tiles_torch followed by the packer); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import collections

import torch

from darwin_tpu_torch import _build
from darwin_tpu_torch.ops.pack import pack_dir_words, pack_dir_words6
from darwin_tpu_torch.ops.reference_dp import align_tiles_torch

# A warp's 32 lanes each hold C columns of a tile in registers (csrc/
# dp.cu by_strip): C <= 32 with one tile a warp; with four, C = 16 needs
# more than the 255 registers a thread may have and spills, so two and
# four tiles a warp stop at C = 12.
MAX_TILE = 1023
MAX_TILE_INTERLEAVED = 384
INTERLEAVES = (1, 2, 4)
# Warps a thread block (lab/geom_sweep.py --warps measures 1-8).
WARPS = 4
MAX_WARPS = 8  # csrc/dp.cu kMaxWarps
PACKERS = {"bytes": None, "packed": pack_dir_words,
           "packed6": pack_dir_words6}
# The C entry's format codes; 3 is the plane-2 variant (ops/plane2.py).
FORMAT_CODES = {"bytes": 0, "packed": 1, "packed6": 2, "plane2": 3}
_STATS = ("max_score", "max_i", "max_j", "pos_score")


def check_tile_size(T: int, what: str, interleave: int = 1) -> None:
    """Raise ValueError for a tile size the CUDA kernel does not take
    (the plain version, on the CPU, takes any)."""
    limit = MAX_TILE if interleave == 1 else MAX_TILE_INTERLEAVED
    if not 1 <= T <= limit:
        raise ValueError(f"{what}: tile size {T} outside 1..{limit}, the "
                         f"CUDA DP kernel's limit at interleave "
                         f"{interleave}")


def check_geometry(B: int, T: int, interleave: int, what: str, *,
                   on_card: bool = True) -> None:
    """Raise ValueError for a geometry the kernel (on_card) or the plain
    version does not take."""
    if interleave not in INTERLEAVES:
        raise ValueError(f"{what}: interleave {interleave} not in "
                         f"{INTERLEAVES}")
    if B % interleave:
        raise ValueError(f"{what}: batch {B} does not divide by "
                         f"interleave {interleave}")
    if on_card:
        check_tile_size(T, what, interleave)


def align_tiles_plain(ref: torch.Tensor, query: torch.Tensor,
                      ref_len: torch.Tensor, query_len: torch.Tensor, *,
                      dir_format: str = "bytes", **scoring) -> dict:
    """The plain version of align_tiles in any dir format, on the
    inputs' device: the byte DP, then the format's packer."""
    out = align_tiles_torch(ref, query, ref_len, query_len, **scoring)
    if dir_format != "bytes":
        out["dir_words"] = PACKERS[dir_format](out.pop("dir"))
    return out


def run_kernel(ref: torch.Tensor, query: torch.Tensor,
               ref_len: torch.Tensor, query_len: torch.Tensor, *,
               match: int, mismatch: int, gap_open: int, gap_extend: int,
               fmt: str, interleave: int, what: str,
               warps: int = WARPS) -> dict:
    """Launch csrc/dp.cu on CUDA tensors, `warps` warps a block (the
    caller counts the launch).  Returns dict(dir [B, T, T+1] uint8 for
    "bytes" or int32 otherwise, dir2 for "plane2", and the four [B]
    int32 stats)."""
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"{what}: {warps} warps a block, not in "
                         f"1..{MAX_WARPS}")
    dev = _build.require_cuda(ref, what)
    B, T = ref.shape
    check_geometry(B, T, interleave, what)
    u8, i32 = torch.uint8, torch.int32
    args = [_build.arg(ref, "ref", u8, (B, T), dev),
            _build.arg(query, "query", u8, (B, T), dev),
            _build.arg(ref_len, "ref_len", i32, (B,), dev),
            _build.arg(query_len, "query_len", i32, (B,), dev)]
    shape = (B, T, T + 1)
    out = dict(dir=torch.empty(shape, dtype=u8 if fmt == "bytes" else i32,
                               device=dev))
    if fmt == "plane2":
        out["dir2"] = torch.empty(shape, dtype=i32, device=dev)
    for k in _STATS:
        out[k] = torch.empty(B, dtype=i32, device=dev)
    if B:
        _build.launch(
            "dtt_align_tiles", dev, *args, B, T, match, mismatch,
            gap_open, gap_extend, FORMAT_CODES[fmt], interleave, warps,
            out["dir"], out.get("dir2"), *(out[k] for k in _STATS))
    return out


def align_tiles(ref: torch.Tensor, query: torch.Tensor,
                ref_len: torch.Tensor, query_len: torch.Tensor, *,
                match: int, mismatch: int, gap_open: int,
                gap_extend: int, dir_format: str = "bytes",
                interleave: int = 1) -> dict:
    """Same contract as align_tiles_torch: ref/query [B, T] uint8,
    ref_len/query_len [B] int32 -> dict(max_score, max_i, max_j,
    pos_score [B] int32, and dir [B, T, T+1] uint8 for "bytes" or
    dir_words [B, T, T+1] int32 for "packed"/"packed6")."""
    if dir_format not in PACKERS:
        raise ValueError(f"align_tiles: dir_format {dir_format!r} not in "
                         f"{tuple(PACKERS)}")
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if ref.device.type == "cpu":
        check_geometry(ref.shape[0], ref.shape[1], interleave, "align_tiles",
                       on_card=False)
        return align_tiles_plain(ref, query, ref_len, query_len,
                                 dir_format=dir_format, **kw)
    out = run_kernel(ref, query, ref_len, query_len, fmt=dir_format,
                     interleave=interleave, what="align_tiles", **kw)
    if ref.shape[0]:
        align_tiles.launches += 1
        align_tiles.variant_launches[(dir_format, interleave)] += 1
    if dir_format != "bytes":
        out["dir_words"] = out.pop("dir")
    return out


# Launches of the kernel, in all and by (dir_format, interleave).
align_tiles.launches = 0
align_tiles.variant_launches = collections.Counter()
