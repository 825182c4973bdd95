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
* T runs up to MAX_TILE = 2048, the reference's limit, at every
  interleave.  Up to ONE_WARP_TILE a warp holds whole tiles (the
  one-warp path); past it one block of S warps holds a tile, each warp
  a strip of its columns, pipelined (the split path; strips_for picks
  S, and run_kernel's ``strips`` forces it for the lab and the tests).
* The split path at interleave 1 in the three formats runs two tiles a
  block in 16-bit halves (the 16-bit split path) where fits_int16 holds
  for T and the scoring: darwin_tpu's bound on the scores stays clear
  of its 16-bit sentinel NEG16.  Else it runs the int32 split kernel.
  The choice is the gate's alone; run_kernel's ``dp16`` forces it for
  the lab and the tests.
* align_tiles_pallas's ``block_b`` is not ported: it is a Mosaic block
  shape.

A CPU tensor runs the plain version, align_tiles_plain
(reference_dp.align_tiles_torch followed by the packer); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import types

import torch

from darwin_tpu_torch import _build
from darwin_tpu_torch.ops.pack import pack_dir_words, pack_dir_words6
from darwin_tpu_torch.ops.reference_dp import align_tiles_torch

# The reference's limit (align.h MAX_TILE_SIZE 2049 bytes a row), for
# every interleave.
MAX_TILE = 2048
INTERLEAVES = (1, 2, 4)
# This module picks the path and the strip width; csrc/dp.cu takes them
# as given and returns an error for a width it does not instantiate.
# The one-warp path: a warp's 32 lanes each hold C columns of a tile in
# registers (csrc/dp.cu by_strip): C <= 32 with one tile a warp; with
# four, C = 16 needs more than the 255 registers a thread may have and
# spills, so two and four tiles a warp stop at C = 12.
ONE_WARP_TILE = {1: 1023, 2: 384, 4: 384}
# The split path (csrc/dp.cu by_split) over larger tiles: one block of S
# warps a tile, each holding C columns a lane, C one of the widths that
# dp.cu instantiates (the widest sets S).
SPLIT_WIDTHS = {1: (8, 12, 16), 2: (8,), 4: (8,)}
# darwin_tpu's int16 -inf sentinel (darwin_tpu/ops/pallas_dp.py:56,
# NEG16; csrc/dp16.cu kNeg16).
NEG16 = -20000
# The 16-bit split path (csrc/dp16.cu by_split16): its formats, at
# interleave 1, the strip widths it instantiates, and its warps a tile by
# tile size, (largest T, S): C = 16 and 24 over two warps up to 1536, C =
# 16 over four up to 2048, the fastest of the card's sweep
# (lab/split_sweep.py; PERF.md section 6).
SPLIT16_FORMATS = ("bytes", "packed", "packed6")
SPLIT16_WIDTHS = (16, 24)
SPLIT16_STRIPS = ((1536, 2), (MAX_TILE, 4))
# Warps a thread block (lab/geom_sweep.py --warps measures 1-8).
WARPS = 4
MAX_WARPS = 8  # csrc/dp.cu kMaxWarps
PACKERS = {"bytes": None, "packed": pack_dir_words,
           "packed6": pack_dir_words6}
# The C entry's format codes; 3 is the plane-2 variant (ops/plane2.py).
FORMAT_CODES = {"bytes": 0, "packed": 1, "packed6": 2, "plane2": 3}
_STATS = ("max_score", "max_i", "max_j", "pos_score")


def check_tile_size(T: int, what: str) -> None:
    """Raise ValueError for a tile size the CUDA kernel does not take
    (the plain version, on the CPU, takes any)."""
    if not 1 <= T <= MAX_TILE:
        raise ValueError(f"{what}: tile size {T} outside 1..{MAX_TILE}, "
                         f"the CUDA DP kernel's limit")


def score_bound(T: int, *, match: int, mismatch: int, gap_open: int,
                gap_extend: int) -> int:
    """A bound on every DP state value (H, M + go, I + ge, D + ge) of a
    T x T tile: darwin_tpu's (T + 2) * max|param| (pallas_dp.py
    _score_dtype) where neither gap scores above 0, so that only the
    diagonal steps gain; twice that where one does, since a path then
    gains on each of its up to 2T steps (at T = 12 the all-+1 scoring
    reaches 23 > 14).  The values never fall below -2 max|param|."""
    p = max(abs(match), abs(mismatch), abs(gap_open), abs(gap_extend))
    return (T + 2 if gap_open <= 0 and gap_extend <= 0 else 2 * T + 2) * p


def fits_int16(T: int, **scoring) -> bool:
    """The 16-bit gate: the scores of a T x T tile stay clear of the
    16-bit sentinel NEG16 (score_bound < -NEG16), so the 16-bit DP
    computes what the int32 DP does.  At the default scoring (+-1) the
    bound is T + 2: every T up to MAX_TILE passes."""
    return score_bound(T, **scoring) < -NEG16


def takes_int16(T: int, fmt: str, interleave: int, strips: int,
                **scoring) -> bool:
    """Whether the gate sends this launch to the 16-bit split path: a
    split launch (strips > 1) at interleave 1 in bytes, packed or
    packed6 with fits_int16."""
    return (strips > 1 and interleave == 1 and fmt in SPLIT16_FORMATS
            and fits_int16(T, **scoring))


def strips_for(T: int, interleave: int, dp16: bool = False) -> int:
    """Warps a tile on the card: 1 (the one-warp path) up to
    ONE_WARP_TILE; past it on the int32 split kernel the least S whose
    strips of the widest split width cover T, on the 16-bit one (dp16)
    SPLIT16_STRIPS's."""
    if T <= ONE_WARP_TILE[interleave]:
        return 1
    if dp16:
        return next(s for t, s in SPLIT16_STRIPS if T <= t)
    return -(-T // (32 * SPLIT_WIDTHS[interleave][-1]))


def check_strips(T: int, interleave: int, strips: int, what: str,
                 dp16: bool = False) -> int:
    """The columns a lane for T over `strips` warps a tile: 0 for the
    one-warp path (strips 1, T up to ONE_WARP_TILE; dp.cu picks its
    width), else the least split width (of SPLIT16_WIDTHS on the 16-bit
    path) whose 32 * strips lanes cover T (strips 2..MAX_WARPS).  Raises
    ValueError when the kernel does not take T that way."""
    if strips == 1 and T <= ONE_WARP_TILE[interleave]:
        return 0
    if 2 <= strips <= MAX_WARPS:
        for width in SPLIT16_WIDTHS if dp16 else SPLIT_WIDTHS[interleave]:
            if 32 * width * strips >= T:
                return width
    raise ValueError(f"{what}: tile size {T} does not run over {strips} "
                     f"warps a tile at interleave {interleave}")


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
        check_tile_size(T, what)


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
               warps: int = WARPS, strips: int | None = None,
               dp16: bool | None = None) -> dict:
    """Launch csrc/dp.cu on CUDA tensors (the caller counts the launch):
    the one-warp path with `warps` warps a block, or the split path with
    one block of `strips` warps a tile, on the 16-bit split kernel
    (csrc/dp16.cu) where `dp16`.  `dp16` defaults to the gate
    (takes_int16) and `strips` to strips_for(T, interleave, dp16); the
    lab and the tests force them (strips 1, or 2 and more at any T the
    width allows; dp16 False for the int32 split kernel under a scoring
    the gate passes, True only where the gate would pass it at that many
    strips).  Returns dict(dir [B, T, T+1] uint8 for "bytes" or int32
    otherwise, dir2 for "plane2", and the four [B] int32 stats)."""
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"{what}: {warps} warps a block, not in "
                         f"1..{MAX_WARPS}")
    dev = _build.require_cuda(ref, what)
    B, T = ref.shape
    check_geometry(B, T, interleave, what)
    scoring = dict(match=match, mismatch=mismatch, gap_open=gap_open,
                   gap_extend=gap_extend)
    gate = takes_int16(T, fmt, interleave,
                       strips or strips_for(T, interleave), **scoring)
    if dp16 is None:
        dp16 = gate
    if strips is None:
        strips = strips_for(T, interleave, dp16)
    if dp16 and not gate:
        raise ValueError(f"{what}: the 16-bit split kernel does not take "
                         f"T={T}, {fmt}, interleave {interleave}, {strips} "
                         f"warps a tile at scoring {scoring}")
    width = check_strips(T, interleave, strips, what, dp16)
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
    if B and dp16:
        _build.launch(
            "dtt_align_tiles16", dev, *args, B, T, match, mismatch,
            gap_open, gap_extend, FORMAT_CODES[fmt], strips, width,
            out["dir"], *(out[k] for k in _STATS))
    elif B:
        _build.launch(
            "dtt_align_tiles", dev, *args, B, T, match, mismatch,
            gap_open, gap_extend, FORMAT_CODES[fmt], interleave, warps,
            strips, width, out["dir"], out.get("dir2"),
            *(out[k] for k in _STATS))
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
        count = kernel_counter(ref.shape[1], dir_format, interleave, **kw)
        count.launches += 1
        count.variant_launches[(dir_format, interleave)] += 1
    if dir_format != "bytes":
        out["dir_words"] = out.pop("dir")
    return out


def kernel_counter(T: int, fmt: str, interleave: int, **scoring):
    """The launch counter of the kernel align_tiles launches for these
    arguments: align_tiles (the one-warp kernel), align_tiles.split (the
    int32 split kernel) or align_tiles.split16 (the 16-bit one)."""
    strips = strips_for(T, interleave)
    if strips == 1:
        return align_tiles
    if takes_int16(T, fmt, interleave, strips, **scoring):
        return align_tiles.split16
    return align_tiles.split


# Launches of the one-warp kernel, in all and by (dir_format,
# interleave); align_tiles.split counts the int32 split kernel's and
# align_tiles.split16 the 16-bit split kernel's the same two ways.
align_tiles.launches = 0
align_tiles.variant_launches = collections.Counter()
align_tiles.split = types.SimpleNamespace(
    launches=0, variant_launches=collections.Counter())
align_tiles.split16 = types.SimpleNamespace(
    launches=0, variant_launches=collections.Counter())
