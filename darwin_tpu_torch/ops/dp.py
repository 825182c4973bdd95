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
* The split path runs the 16-bit split kernel (csrc/dp16.cu: a pair
  of tiles in the 16-bit halves of its registers, at every interleave)
  in every format, plane 2 included, where fits_int16 holds for T and
  the scoring (darwin_tpu's bound on the scores stays clear of its
  16-bit sentinel NEG16) and the card did not measure it slower
  (SPLIT16_SLOWER); else the int32 split kernel.
  plan() makes the choice, run_kernel launches it and returns which
  kernel it launched, and the launch counters (COUNTERS) count on that;
  run_kernel's ``strips``, ``dp16`` and ``width`` force it for the lab
  and the tests.
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
# The kernels run_kernel launches: the one-warp kernel (csrc/dp.cu), the
# int32 split kernel (csrc/dp.cu) and the 16-bit split kernel
# (csrc/dp16.cu), each counted on its own counter (COUNTERS).
ONE_WARP, SPLIT, SPLIT16 = "one_warp", "split", "split16"
# The 16-bit split path: its formats, at every interleave (plane 2 at 1
# only, as on the int32 kernel).
SPLIT16_FORMATS = ("bytes", "packed", "packed6", "plane2")
# Its warps a tile by tile size, (largest T, S), at every interleave (the
# fastest of the sweep; where no width of the format covers T at that S,
# the least S that one does).
SPLIT16_STRIPS = ((512, 1), (1536, 2), (MAX_TILE, 4))
# Shapes where the card's sweep (lab/split_sweep.py at T = 1024, 1536,
# 2048, B = 512 and 2048, full tiles and lengths drawn in 1..T; PERF.md
# section 6) found the int32 split kernel faster, or the two within a
# few percent either way, {(format, interleave): ((least T, largest T),
# ...)}: at interleave 1, packed up to T = 1536, packed6 and plane 2 at
# every T (the int32 kernel holds one tile a block, so twice the blocks
# share an SM).  The gate keeps them there.
SPLIT16_SLOWER = {("packed", 1): ((1024, 1536),),
                  ("packed6", 1): ((1024, MAX_TILE),),
                  ("plane2", 1): ((1024, MAX_TILE),)}
# Warps a thread block (lab/geom_sweep.py --warps measures 1-8).
WARPS = 4
MAX_WARPS = 8  # csrc/dp.cu kMaxWarps
# The split kernels' shared memory (csrc/dp_common.cuh): the card's 227
# KB a block (kMaxSmem), lanes a row-emitting group (kGroup), boundary
# ring entries (kBnd), and the rows a word format reads above its own
# (Lag).
MAX_SMEM = 227 * 1024
GROUP = 16
BND = 32
LAG = {"bytes": 0, "packed": 1, "packed6": 3, "plane2": 6}
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


def runs_int16(T: int, fmt: str, interleave: int, **scoring) -> bool:
    """Whether the 16-bit split kernel computes this launch: a format it
    takes at that interleave (plane 2 at 1 only, as on the int32 kernel)
    and fits_int16."""
    return (fmt in SPLIT16_FORMATS and interleave in INTERLEAVES
            and (fmt != "plane2" or interleave == 1)
            and fits_int16(T, **scoring))


def takes_int16(T: int, fmt: str, interleave: int, strips: int,
                **scoring) -> bool:
    """Whether the gate sends this launch to the 16-bit split path: a
    split launch (strips > 1, or T past the one-warp path) that
    runs_int16 takes, at a shape where the card measured it no slower
    than the int32 split kernel (not in SPLIT16_SLOWER)."""
    slower = any(lo <= T <= hi
                 for lo, hi in SPLIT16_SLOWER.get((fmt, interleave), ()))
    return ((strips > 1 or T > ONE_WARP_TILE[interleave]) and not slower
            and runs_int16(T, fmt, interleave, **scoring))


def split16_widths(fmt: str) -> tuple:
    """The strip widths csrc/dp16.cu instantiates for fmt: C = 16, and
    for bytes 24."""
    return (16, 24) if fmt == "bytes" else (16,)


def strips_for(T: int, interleave: int, dp16: bool = False,
               fmt: str = "bytes") -> int:
    """Warps a tile on the card: on the int32 kernels 1 (the one-warp
    path) up to ONE_WARP_TILE, past it the least S whose strips of the
    widest split width cover T; on the 16-bit one (dp16) SPLIT16_STRIPS's,
    or more where no width of fmt covers T at that S."""
    if dp16:
        least = -(-T // (32 * split16_widths(fmt)[-1]))
        return max(least, next(s for t, s in SPLIT16_STRIPS if T <= t))
    if T <= ONE_WARP_TILE[interleave]:
        return 1
    return -(-T // (32 * SPLIT_WIDTHS[interleave][-1]))


def _round16(x: int) -> int:
    return (x + 15) & ~15


def split_smem(kernel: str, fmt: str, interleave: int, strips: int,
               width: int, T: int) -> int:
    """Bytes of shared memory a block of a split kernel takes: csrc/dp.cu
    split_smem (SPLIT) or csrc/dp16.cu split16_smem (SPLIT16), with
    dp_common.cuh's RingOf (16-aligned rings of GROUP + 1 + LAG rows, the
    16-bit kernel's one row more, and a zero row, of GROUP * width + 8
    bytes; two groups a warp)."""
    extra = 1 if kernel == SPLIT16 else 0
    rows = GROUP + 1 + extra + LAG[fmt]
    ring = _round16((rows + 1) * (GROUP * width + 8))
    rings = strips * (32 // GROUP) * ring
    if kernel == SPLIT16:  # two tiles, the ref rows as pairs, Bnd16 of 32
        return (2 * rings + _round16(4 * (T + 32))
                + (strips + 1) * BND * 32 + 2 * strips * 12)
    return (interleave * (rings + _round16(T + 32))
            + strips * interleave * (BND * 16 + 12))


def check_strips(T: int, interleave: int, strips: int, what: str,
                 dp16: bool = False, fmt: str = "bytes") -> int:
    """The columns a lane for T over `strips` warps a tile: on the int32
    kernels 0 for the one-warp path (strips 1, T up to ONE_WARP_TILE;
    dp.cu picks its width), else the least split width whose 32 * strips
    lanes cover T (strips 2..MAX_WARPS); on the 16-bit kernel (dp16) the
    least of split16_widths covering T over 1..MAX_WARPS warps.  Raises
    ValueError when the kernel does not take T that way."""
    if dp16:
        widths, lo = split16_widths(fmt), 1
    else:
        if strips == 1 and T <= ONE_WARP_TILE[interleave]:
            return 0
        widths, lo = SPLIT_WIDTHS[interleave], 2
    if lo <= strips <= MAX_WARPS:
        for width in widths:
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


class Plan(collections.namedtuple("Plan", "kernel strips width")):
    """What run_kernel launches: kernel ONE_WARP, SPLIT or SPLIT16, warps
    a tile (1 on the one-warp path) and columns a lane (0 on the one-warp
    path: dp.cu picks it)."""


def plan(T: int, fmt: str, interleave: int, *, strips: int | None = None,
         dp16: bool | None = None, width: int | None = None,
         what: str = "plan", **scoring) -> Plan:
    """The launch run_kernel makes for these arguments.  By default the
    one-warp kernel up to ONE_WARP_TILE, past it the 16-bit split kernel
    where the gate (takes_int16) passes, else the int32 split kernel, at
    strips_for's warps a tile.  The lab and the tests force `strips`
    (1 the one-warp path, unless dp16), `dp16` (False the int32 kernels;
    True the 16-bit one wherever runs_int16 holds, at any T its strips
    cover) and, on a split kernel, `width` (one it instantiates whose
    strips cover T, not only the least); a forced 16-bit launch outside
    runs_int16, or a split launch whose block passes the card's shared
    memory (split_smem > MAX_SMEM), raises ValueError."""
    gate = takes_int16(T, fmt, interleave,
                       strips or strips_for(T, interleave), **scoring)
    if dp16 is None:
        dp16 = gate and strips != 1
    if dp16 and not runs_int16(T, fmt, interleave, **scoring):
        raise ValueError(f"{what}: the 16-bit split kernel does not take "
                         f"T={T}, {fmt}, interleave {interleave} at scoring "
                         f"{scoring}")
    if not dp16:
        strips = strips or strips_for(T, interleave)
        least = check_strips(T, interleave, strips, what)
        widths = SPLIT_WIDTHS[interleave]
        kernel = ONE_WARP if least == 0 else SPLIT
    else:
        strips = strips or strips_for(T, interleave, True, fmt)
        least = check_strips(T, interleave, strips, what, True, fmt)
        widths = split16_widths(fmt)
        kernel = SPLIT16
    if width is None:
        width = least
    elif width != least and (kernel == ONE_WARP or width not in widths
                             or width < least):
        raise ValueError(f"{what}: width {width} is not one the {kernel} "
                         f"kernel takes for T={T} over {strips} warps")
    if kernel != ONE_WARP and split_smem(kernel, fmt, interleave, strips,
                                         width, T) > MAX_SMEM:
        raise ValueError(f"{what}: the {kernel} kernel at T={T} over "
                         f"{strips} warps of width {width} needs more than "
                         f"the card's {MAX_SMEM} bytes of shared memory a "
                         f"block")
    return Plan(kernel, strips, width)


def run_kernel(ref: torch.Tensor, query: torch.Tensor,
               ref_len: torch.Tensor, query_len: torch.Tensor, *,
               match: int, mismatch: int, gap_open: int, gap_extend: int,
               fmt: str, interleave: int, what: str,
               warps: int = WARPS, strips: int | None = None,
               dp16: bool | None = None, width: int | None = None) -> tuple:
    """Launch the tile DP on CUDA tensors as plan() picks it: the
    one-warp kernel with `warps` warps a block (csrc/dp.cu), the int32
    split kernel (csrc/dp.cu) or the 16-bit one (csrc/dp16.cu), one
    block of strips warps a tile (a pair of tiles on the 16-bit one).
    Returns (dict(dir [B, T, T+1] uint8 for "bytes" or int32 otherwise,
    dir2 for "plane2", and the four [B] int32 stats), the kernel it
    launched: ONE_WARP, SPLIT or SPLIT16); the caller counts the
    launch."""
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"{what}: {warps} warps a block, not in "
                         f"1..{MAX_WARPS}")
    dev = _build.require_cuda(ref, what)
    B, T = ref.shape
    check_geometry(B, T, interleave, what)
    scoring = dict(match=match, mismatch=mismatch, gap_open=gap_open,
                   gap_extend=gap_extend)
    p = plan(T, fmt, interleave, strips=strips, dp16=dp16, width=width,
             what=what, **scoring)
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
    if B and p.kernel == SPLIT16:
        _build.launch(
            "dtt_align_tiles16", dev, *args, B, T, match, mismatch,
            gap_open, gap_extend, FORMAT_CODES[fmt], interleave, p.strips,
            p.width, out["dir"], out.get("dir2"), *(out[k] for k in _STATS))
    elif B:
        _build.launch(
            "dtt_align_tiles", dev, *args, B, T, match, mismatch,
            gap_open, gap_extend, FORMAT_CODES[fmt], interleave, warps,
            p.strips, p.width, out["dir"], out.get("dir2"),
            *(out[k] for k in _STATS))
    return out, p.kernel


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
    out, kernel = run_kernel(ref, query, ref_len, query_len, fmt=dir_format,
                             interleave=interleave, what="align_tiles", **kw)
    if ref.shape[0]:
        count = COUNTERS[kernel]
        count.launches += 1
        count.variant_launches[(dir_format, interleave)] += 1
    if dir_format != "bytes":
        out["dir_words"] = out.pop("dir")
    return out


def kernel_counter(T: int, fmt: str, interleave: int, **scoring):
    """The counter of the kernel align_tiles launches for these arguments
    (plan's choice): align_tiles (the one-warp kernel),
    align_tiles.split (the int32 split kernel) or align_tiles.split16
    (the 16-bit one)."""
    return COUNTERS[plan(T, fmt, interleave, **scoring).kernel]


# Launches of the one-warp kernel, in all and by (dir_format,
# interleave); align_tiles.split counts the int32 split kernel's and
# align_tiles.split16 the 16-bit split kernel's the same two ways.
align_tiles.launches = 0
align_tiles.variant_launches = collections.Counter()
align_tiles.split = types.SimpleNamespace(
    launches=0, variant_launches=collections.Counter())
align_tiles.split16 = types.SimpleNamespace(
    launches=0, variant_launches=collections.Counter())
COUNTERS = {ONE_WARP: align_tiles, SPLIT: align_tiles.split,
            SPLIT16: align_tiles.split16}
