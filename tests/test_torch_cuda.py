"""darwin_tpu_torch's CUDA kernels on the card, against their plain
PyTorch versions (which the other test_torch_* files hold against the
JAX package).  Every test here needs a CUDA device and skips without
one.  The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py -q

All outputs are integers: the tolerance is 0.
"""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.engine.device_batch import (DeviceGactEngine,
                                                  gate_engages)
from darwin_tpu_torch.ops import (dp, plane2, scanshift, swscore, tile_fetch,
                                  traceback)
from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF
from darwin_tpu_torch.ops.reference_dp import align_tiles_torch
from darwin_tpu_torch.ops.tile_fetch import fetch_tiles_torch
from darwin_tpu_torch.ops.traceback import traceback_torch
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import parse_fasta
from darwin_tpu_torch.pipeline import run_pipeline

pytestmark = pytest.mark.cuda
REPO = Path(__file__).resolve().parent.parent
TINY = REPO / "tests" / "data" / "tiny"
SCORINGS = [(1, -1, -1, -1), (2, -3, -4, -2), (3, -1, -2, -1),
            (2, 1, -3, -1), (2, -1, 1, -2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tiles(seed, B, T, device):
    """Related ACGT tiles (15% substitutions, a shifted copy in every
    fourth lane for gaps), random lengths, padded; lanes 0-2 idle, empty
    ref, empty query."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    src = acgt[rng.integers(0, 4, size=(B, T + 8))]
    ref = src[:, :T].copy()
    query = src[:, :T].copy()
    query[::4] = src[::4, 8:]
    mut = rng.random((B, T)) < 0.15
    query[mut] = acgt[rng.integers(0, 4, size=int(mut.sum()))]
    rlen = rng.integers(1, T + 1, size=B).astype(np.int32)
    qlen = rng.integers(1, T + 1, size=B).astype(np.int32)
    rlen[0] = qlen[0] = rlen[1] = qlen[2] = 0
    k = np.arange(T)[None, :]
    ref[k >= rlen[:, None]] = PAD_REF
    query[k >= qlen[:, None]] = PAD_QUERY
    first = rng.random(B) < 0.5
    return [torch.from_numpy(x).to(device)
            for x in (ref, query, rlen, qlen, first)]


@pytest.mark.parametrize("T,et", [(64, 40), (320, 200), (376, 256)])
def test_dp_and_walker_kernels_match_plain(cuda, T, et):
    ref, query, rlen, qlen, first = _tiles(T, 64, T, cuda)
    for sc in SCORINGS:
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
        n = dp.align_tiles.launches
        got = dp.align_tiles(ref, query, rlen, qlen, **kw)
        assert dp.align_tiles.launches == n + 1
        want = align_tiles_torch(ref, query, rlen, qlen, **kw)
        for key in want:
            assert torch.equal(got[key], want[key]), (sc, key)
        args = (got["dir"], rlen, qlen, first, got["max_i"], got["max_j"])
        n = traceback.traceback.launches
        g = traceback.traceback(*args, early_terminate=et)
        assert traceback.traceback.launches == n + 1
        w = traceback_torch(*args, early_terminate=et)
        for a, b in zip(g, w):
            assert torch.equal(a, b), sc


@pytest.mark.parametrize("T", [64, 320, 376])
def test_dp_word_formats_and_interleave_match_plain(cuda, T):
    """Every dir format at interleave 1, 2 and 4 equals the plain
    version (byte DP, then the packer), with rlen < T tiles, whose rows
    past rlen still carry bytes in their words."""
    ref, query, rlen, qlen, _ = _tiles(T + 1, 64, T, cuda)
    for sc in SCORINGS[:3]:
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
        plain = align_tiles_torch(ref, query, rlen, qlen, **kw)
        for fmt, packer in dp.PACKERS.items():
            want = dict(plain)
            if packer is not None:
                want["dir_words"] = packer(want.pop("dir"))
            for il in dp.INTERLEAVES:
                n = dp.align_tiles.variant_launches[(fmt, il)]
                got = dp.align_tiles(ref, query, rlen, qlen, dir_format=fmt,
                                     interleave=il, **kw)
                assert dp.align_tiles.variant_launches[(fmt, il)] == n + 1
                assert got.keys() == want.keys()
                for key in want:
                    assert torch.equal(got[key], want[key]), (sc, fmt, il,
                                                              key)


def _edge_tiles(seed, B, T, device):
    """chip_smoke.edge_tiles from seed, on device: [B, T] tiles with the
    DP's edge cases in lanes 0-7 (idle, empty ref, empty query,
    all-mismatch full tile, all-mismatch rlen < T and qlen < T,
    identical full tile, a one-column and a one-row tile); the rest
    related ACGT (15% substitutions) of random lengths in 1..T."""
    return [torch.from_numpy(x).to(device) for x in
            chip_smoke.edge_tiles(np.random.default_rng(seed), B, T)]


@pytest.mark.parametrize("T", [1, 24, 31, 32, 33, 64, 320, 376, 384, 385,
                               504, 1023, 1024, 1025, 1536, 2047,
                               dp.MAX_TILE])
def test_dp_kernel_edge_geometries_match_plain(cuda, T):
    """The warp-wavefront DP in every format and interleave, and plane
    2, bit-exact against the plain version under three scorings, at the
    strip widths' edges (T = 31, 32, 33, 64, 320, ...), at each side of
    the one-warp path's limits (384 / 385 interleaved, 1023 / 1024) and
    on the split path up to the largest tiles allowed (1025: one column
    past two strips; 2047, 2048), on edge-case tiles, B = 36 (not a
    multiple of 32).  An all-mismatch tile's max cell is (rlen, qlen) at
    score 0."""
    B = 36
    ref, query, rlen, qlen = _edge_tiles(T, B, T, cuda)
    for sc in SCORINGS[:3]:
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
        plain = align_tiles_torch(ref, query, rlen, qlen, **kw)
        for lane in (3, 4):
            assert int(plain["max_score"][lane]) == 0
            assert (int(plain["max_i"][lane]), int(plain["max_j"][lane])) \
                == (int(rlen[lane]), int(qlen[lane]))
        for fmt, packer in dp.PACKERS.items():
            want = dict(plain)
            if packer is not None:
                want["dir_words"] = packer(want.pop("dir"))
            for il in dp.INTERLEAVES:
                got = dp.align_tiles(ref, query, rlen, qlen, dir_format=fmt,
                                     interleave=il, **kw)
                for key in want:
                    assert torch.equal(got[key], want[key]), (sc, fmt, il,
                                                              key)
        got = plane2.plane2(ref, query, rlen, qlen, **kw)
        want = plane2.plane2_torch(ref, query, rlen, qlen, **kw)
        for key in want:
            assert torch.equal(got[key], want[key]), (sc, "plane2", key)


@pytest.mark.parametrize("T", [320, 1023])
def test_forced_split_equals_the_one_warp_path(cuda, T):
    """The split path forced (run_kernel's strips) over 1 (the 16-bit
    kernel only), 2, 3, 4 and 8 warps a tile, where their strips cover T,
    in every format and interleave and plane 2 on the int32 split kernel
    and on the 16-bit one, gives the one-warp path's outputs."""
    ref, query, rlen, qlen = _edge_tiles(T + 7, 36, T, cuda)
    kw = dict(match=2, mismatch=-3, gap_open=-4, gap_extend=-2)
    runs = 0
    for fmt in (*dp.PACKERS, "plane2"):
        want = dp.run_kernel(ref, query, rlen, qlen, fmt=fmt, interleave=1,
                             what="test", strips=1, **kw)[0]
        for il in dp.INTERLEAVES:
            for dp16 in chip_smoke._split_kinds(T, fmt, il, kw):
                for strips in (1, 2, 3, 4, 8):
                    try:
                        p = dp.plan(T, fmt, il, strips=strips, dp16=dp16,
                                    **kw)
                    except ValueError:
                        continue
                    if p.kernel == dp.ONE_WARP:
                        continue
                    got, kernel = dp.run_kernel(
                        ref, query, rlen, qlen, fmt=fmt, interleave=il,
                        what="test", strips=strips, dp16=dp16, **kw)
                    assert kernel == p.kernel
                    runs += 1
                    for key in want:
                        assert torch.equal(got[key], want[key]), (
                            fmt, il, strips, dp16, key)
    assert runs >= 60


def test_split_path_counts_its_launches(cuda):
    """Past the one-warp limit align_tiles and plane2 launch the split
    path and count it apart from the one-warp kernel's counters: on
    align_tiles.split16 / plane2.split16 (the 16-bit kernel) where the
    gate passes the scoring and the shape, on align_tiles.split /
    plane2.split (the int32 kernel) where it does not (a scoring outside
    the gate; the shapes of SPLIT16_SLOWER); at T = 1023 neither."""
    at = dp.align_tiles
    outside = dict(match=40, mismatch=-30, gap_open=-64, gap_extend=-20)
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    for T, split in ((1023, 0), (1024, 1), (2048, 1)):
        ref, query, rlen, qlen = _edge_tiles(T, 8, T, cuda)
        for scoring in (kw, outside):
            for fmt in ("bytes", "packed6"):
                on16 = int(dp.plan(T, fmt, 1, **scoring).kernel == dp.SPLIT16)
                slower = any(lo <= T <= hi for lo, hi in
                             dp.SPLIT16_SLOWER.get((fmt, 1), ()))
                assert on16 == int(split and scoring is kw and not slower)
                n = (at.launches, at.variant_launches[(fmt, 1)],
                     at.split.launches, at.split.variant_launches[(fmt, 1)],
                     at.split16.launches,
                     at.split16.variant_launches[(fmt, 1)])
                dp.align_tiles(ref, query, rlen, qlen, dir_format=fmt,
                               **scoring)
                s16, s32 = split * on16, split * (1 - on16)
                assert (at.launches, at.variant_launches[(fmt, 1)],
                        at.split.launches,
                        at.split.variant_launches[(fmt, 1)],
                        at.split16.launches,
                        at.split16.variant_launches[(fmt, 1)]) == (
                    n[0] + 1 - split, n[1] + 1 - split, n[2] + s32,
                    n[3] + s32, n[4] + s16, n[5] + s16)
            on16 = int(split and dp.plan(T, "plane2", 1, **scoring).kernel
                       == dp.SPLIT16)
            n = (plane2.plane2.launches, plane2.plane2.split.launches,
                 plane2.plane2.split16.launches)
            plane2.plane2(ref, query, rlen, qlen, **scoring)
            assert (plane2.plane2.launches, plane2.plane2.split.launches,
                    plane2.plane2.split16.launches) == (
                n[0] + 1 - split, n[1] + split * (1 - on16),
                n[2] + on16)


@pytest.mark.parametrize("T", [1024, 1025, 1536, 2047, dp.MAX_TILE])
def test_dp16_kernel_matches_plain(cuda, T):
    """The 16-bit split kernel (forced, and the gate's launch, counted on
    the kernel plan picks, at the default scoring and at (2, -3, -4, -2))
    bit-exact against the plain version on edge tiles in bytes, packed
    and packed6, on an odd batch (35: the last block's second tile
    idles) and an even one, and the int32 split kernel, forced on the
    same inputs, equal to both."""
    ref, query, rlen, qlen = _edge_tiles(T + 1, 36, T, cuda)
    for sc in ((1, -1, -1, -1), (2, -3, -4, -2)):
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
        assert dp.fits_int16(T, **kw)
        plain = align_tiles_torch(ref, query, rlen, qlen, **kw)
        for fmt, packer in dp.PACKERS.items():
            want = dict(plain)
            key = "dir" if packer is None else "dir_words"
            want[key] = want.pop("dir") if packer is None else packer(
                want.pop("dir"))
            for B in (35, 36):
                counter = dp.COUNTERS[dp.plan(T, fmt, 1, **kw).kernel]
                n = counter.launches
                got = dp.align_tiles(ref[:B], query[:B], rlen[:B], qlen[:B],
                                     dir_format=fmt, **kw)
                assert counter.launches == n + 1
                for k in want:
                    assert torch.equal(got[k], want[k][:B]), (sc, fmt, B, k)
                got, kernel = dp.run_kernel(
                    ref[:B], query[:B], rlen[:B], qlen[:B], fmt=fmt,
                    interleave=1, what="test", dp16=True, **kw)
                assert kernel == dp.SPLIT16
                got[key] = got.pop("dir")
                for k in want:
                    assert torch.equal(got[k], want[k][:B]), (sc, fmt, B,
                                                              "16-bit", k)
            got, kernel = dp.run_kernel(ref, query, rlen, qlen, fmt=fmt,
                                        interleave=1, what="test",
                                        dp16=False, **kw)
            assert kernel == dp.SPLIT
            got[key] = got.pop("dir")
            for k in want:
                assert torch.equal(got[k], want[k]), (sc, fmt, "int32", k)


@pytest.mark.parametrize("T", [1024, 2048])
def test_scoring_outside_the_gate_runs_the_int32_split_kernel(cuda, T):
    """A scoring whose bound passes the 16-bit sentinel (max|param| 64)
    runs the int32 split kernel, bit-exact against the plain version in
    every format; forcing the 16-bit kernel on it raises."""
    ref, query, rlen, qlen = _edge_tiles(T + 2, 36, T, cuda)
    kw = dict(match=40, mismatch=-30, gap_open=-64, gap_extend=-20)
    assert not dp.fits_int16(T, **kw)
    plain = align_tiles_torch(ref, query, rlen, qlen, **kw)
    for fmt, packer in dp.PACKERS.items():
        want = dict(plain)
        if packer is not None:
            want["dir_words"] = packer(want.pop("dir"))
        n32 = dp.align_tiles.split.launches
        got = dp.align_tiles(ref, query, rlen, qlen, dir_format=fmt, **kw)
        assert dp.align_tiles.split.launches == n32 + 1
        for k in want:
            assert torch.equal(got[k], want[k]), (fmt, k)
        with pytest.raises(ValueError, match="16-bit"):
            dp.run_kernel(ref, query, rlen, qlen, fmt=fmt, interleave=1,
                          what="test", dp16=True, **kw)


@pytest.mark.parametrize("warps", [1, 2, 3, 8])
def test_dp_kernel_warps_a_block_give_the_same_result(cuda, warps):
    """Any number of warps a block, including one that leaves the last
    block part-empty, gives the default launch's outputs."""
    ref, query, rlen, qlen = _edge_tiles(warps, 100, 320, cuda)
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    for fmt, il in (("bytes", 1), ("packed6", 2), ("plane2", 1)):
        want = dp.run_kernel(ref, query, rlen, qlen, fmt=fmt, interleave=il,
                             what="test", **kw)[0]
        got = dp.run_kernel(ref, query, rlen, qlen, fmt=fmt, interleave=il,
                            what="test", warps=warps, **kw)[0]
        for key in want:
            assert torch.equal(got[key], want[key]), (fmt, il, key)


@pytest.mark.parametrize("T,et", [(64, 40), (320, 200), (376, 256)])
def test_word_walker_kernels_match_plain(cuda, T, et):
    """Both word walkers at B = 512 under three scorings, rlen < T tiles,
    packed at unroll 1, 2, 4 and packed6 at compact_b 0, 64, 512 (512 =
    B: compaction off), against the lockstep plain versions."""
    ref, query, rlen, qlen, first = _tiles(T + 3, 512, T, cuda)
    for sc in SCORINGS[:3]:
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
        for fmt, walk, plain, opts in (
                ("packed", traceback.traceback_packed,
                 traceback.traceback_packed_torch,
                 [dict(unroll=u) for u in (1, 2, 4)]),
                ("packed6", traceback.traceback_packed6,
                 traceback.traceback_packed6_torch,
                 [dict(compact_b=k) for k in (0, 64, 512)])):
            out = dp.align_tiles(ref, query, rlen, qlen, dir_format=fmt,
                                 **kw)
            args = (out["dir_words"], rlen, qlen, first, out["max_i"],
                    out["max_j"])
            for opt in opts:
                n = walk.launches
                got = walk(*args, early_terminate=et, **opt)
                assert walk.launches == n + 1
                want = plain(*args, early_terminate=et, **opt)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (sc, fmt, opt)
                assert (got[0] != 0).any()


@pytest.mark.parametrize("B", [1, 36, 64])
def test_swscore_kernel_edge_shapes_match_plain(cuda, B):
    """The block-a-pair SW kernel at its tiling's edges
    (chip_smoke.sw_edge_shapes: one below, at and one above a pass of
    the least and the most columns a lane, two and three passes under
    short and long refs, refs shorter than the warps, one-row and
    one-column pairs), with empty and full-length lanes, under three
    scorings."""
    import chip_smoke

    rng = np.random.default_rng(B)
    for LR, LQ in chip_smoke.sw_edge_shapes():
        t = [torch.from_numpy(x).to(cuda)
             for x in chip_smoke.sw_edge_pairs(rng, B, LR, LQ)]
        for sc in SCORINGS[:3]:
            kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                          sc))
            n = swscore.local_score_batch.launches
            got = swscore.local_score_batch(*t, **kw)
            assert swscore.local_score_batch.launches == n + 1
            want = swscore.local_score_batch_torch(*t, **kw)
            assert torch.equal(got, want), (LR, LQ, sc)


@pytest.mark.parametrize("B", [1, 36, 512])
@pytest.mark.parametrize("T", [1, 32, 64, 320, 376, dp.MAX_TILE])
def test_windowed_word_walkers_match_plain(cuda, T, B):
    """Both word walkers (one warp a tile over shared-memory windows of
    words) against their plain versions at two early_terminates: on
    chip_smoke.walk_cases lanes packed by the plain packers, and on the
    DP's words of related tiles under three scorings; packed6 also with
    compaction's wider stream."""
    import chip_smoke

    rng = np.random.default_rng(T * 11 + B)
    dirm, *rest = (torch.from_numpy(x).to(cuda)
                   for x in chip_smoke.walk_case_batch(rng, T, B))
    lanes = slice(None, B) if B >= 3 else slice(-B, None)
    ref, query, rlen, qlen, first = (x[lanes] for x in
                                     _tiles(T + B + 1, max(B, 3), T, cuda))
    for fmt, walk, plain, opts in (
            ("packed", traceback.traceback_packed,
             traceback.traceback_packed_torch, [{}]),
            ("packed6", traceback.traceback_packed6,
             traceback.traceback_packed6_torch,
             [{}, dict(compact_b=max(1, B // 8))])):
        inputs = [(dp.PACKERS[fmt](dirm), *rest)]
        for sc in SCORINGS[:3]:
            kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                          sc))
            out = dp.align_tiles(ref, query, rlen, qlen, dir_format=fmt,
                                 **kw)
            inputs.append((out["dir_words"], rlen, qlen, first,
                           out["max_i"], out["max_j"]))
        for k, args in enumerate(inputs):
            for et in sorted({max(1, T * 5 // 8), T}):
                for opt in opts:
                    want = plain(*args, early_terminate=et, **opt)
                    n = walk.launches
                    got = walk(*args, early_terminate=et, **opt)
                    assert walk.launches == n + 1
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), (fmt, k, et, opt)


def test_swscore_kernel_reads_a_ref_past_the_staged_prefix(cuda):
    """A ref longer than the kernel stages in shared memory (kRefCap,
    160 KiB): a 40-base query copied, two bases changed, from row
    164000 of a 165000-base random ref scores as the plain version does
    on a 200-row window around the copy."""
    rng = np.random.default_rng(165)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = acgt[rng.integers(0, 4, size=(2, 165_000))]
    query = ref[:, 164_000:164_040].copy()
    query[:, [7, 30]] = np.where(query[:, [7, 30]] == ord("A"), ord("C"),
                                 ord("A"))
    lens = [np.full(2, n, np.int32) for n in (165_000, 40, 200)]
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    got = swscore.local_score_batch(
        *(torch.from_numpy(x).to(cuda) for x in (ref, query, *lens[:2])),
        **kw)
    want = swscore.local_score_batch_torch(
        *(torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
          for x in (ref[:, 163_900:164_100], query, lens[2], lens[1])), **kw)
    assert torch.equal(got, want) and int(want.min()) >= 34


def test_word_walkers_reject_too_wide_streams(cuda):
    """The word walkers refuse an early_terminate below 1, and take the
    stream widths their shared op buffer once refused (packed past ET
    24960, packed6 past 12479): the buffer is written out in chunks."""
    words = torch.zeros((2, 8, 9), dtype=torch.int32, device=cuda)
    n2 = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    args = (words, n2, n2, n2.bool(), n2, n2)
    for walk, plain, et in (
            (traceback.traceback_packed, traceback.traceback_packed_torch,
             24961),
            (traceback.traceback_packed6, traceback.traceback_packed6_torch,
             12480)):
        with pytest.raises(ValueError, match="early_terminate"):
            walk(*args, early_terminate=0)
        got = walk(*args, early_terminate=et)
        for g, w in zip(got, plain(*args, early_terminate=et)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("fmt", ["bytes", "packed", "packed6"])
def test_walkers_take_any_early_terminate(cuda, fmt):
    """Each walker at chip_smoke.LARGE_ET (30000; packed6 16000), T = 320,
    B = 16, on walk_cases tiles (gap runs past row 0 and column 0 go on
    to ET steps, past many flushes of the op buffer) and on the DP's
    output of related tiles, and at chip_smoke.EDGE_ET (the last stream
    one op buffer holds, the first that takes two): bit-exact against
    its plain version."""
    import chip_smoke

    cases = [c for c in chip_smoke.large_et_walks(cuda) if c[1] == fmt]
    assert len(cases) == 4
    walk = traceback.WALKERS[fmt][1]
    for case, _, args, et in cases:
        n = walk.launches
        got = walk(*args, early_terminate=et)
        assert walk.launches == n + 1
        want = chip_smoke._walker_pairs(fmt, et, args)[1]()
        for g, w in zip(got, want):
            assert torch.equal(g, w), case
    assert int((got[1] + got[2]).max()) > 0


@pytest.mark.parametrize("index", ["twolevel", "searchsorted", "dense"])
def test_dsoft_kernel_matches_plain_and_golden(cuda, index):
    """csrc/dsoft.cu on chip_smoke.dsoft_cases (tests/test_dsoft_device.py's
    cases: three seeds, N bases with a num_seeds cap of 40,
    max_candidates 2, tup_max 8, cand_max 1, empty and 4-base reads, a
    table past 2^31, tup_max 32768, and the budget-edge batch under four
    tup_max): all four outputs equal the plain version's, the candidates
    of every read that did not overflow equal dsoft_scalar's, one launch
    a call; the large path runs reads from shared memory and from device
    memory."""
    import chip_smoke
    from darwin_tpu_torch.dsoft.device import (dsoft_device_batch,
                                               dsoft_device_batch_torch)
    from darwin_tpu_torch.golden.dsoft import dsoft_scalar

    overflowed = 0
    large = {False: 0, True: 0}
    for name, gt, reads, kw in chip_smoke.dsoft_cases():
        args, akw = chip_smoke.dsoft_case_args(gt, reads, kw, index, cuda)
        n_large, in_dev = chip_smoke.dsoft_large_reads(args, akw)
        large[in_dev] += n_large
        n = dsoft_device_batch.launches
        got = dsoft_device_batch(*args, **akw)
        assert dsoft_device_batch.launches == n + 1
        want = dsoft_device_batch_torch(*args, **akw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), name
        hits, offs, counts, over = (x.cpu().numpy() for x in got)
        overflowed += int(over.sum())
        for i, r in enumerate(reads):
            if not over[i]:
                gold = dsoft_scalar(gt, r, kw["num_seeds_cap"],
                                    kw["threshold"], kw["max_candidates"])
                assert list(zip(hits[i, :counts[i]].tolist(),
                                offs[i, :counts[i]].tolist())) == gold, name
    assert overflowed > 0
    assert large[False] >= 2 and large[True] >= 2


def test_dsoft_kernel_rejects_bad_arguments(cuda):
    import chip_smoke
    from darwin_tpu_torch.dsoft.device import dsoft_device_batch

    name, gt, reads, kw = chip_smoke.dsoft_cases()[0]
    args, akw = chip_smoke.dsoft_case_args(gt, reads[:2], kw, "searchsorted",
                                           cuda)
    q, qlens, th, tpos = args
    with pytest.raises(TypeError):
        dsoft_device_batch(q, qlens.long(), th, tpos, **akw)
    with pytest.raises(ValueError):
        dsoft_device_batch(q, qlens, th.cpu(), tpos, **akw)
    with pytest.raises(ValueError):
        dsoft_device_batch(q, qlens, th, tpos, **dict(akw, index="hashmap"))
    with pytest.raises(ValueError):
        dsoft_device_batch(q, qlens, th, tpos, **dict(akw, k=16))
    with pytest.raises(ValueError):  # a bin's counts past int32
        dsoft_device_batch(q, qlens, th, tpos,
                           **dict(akw, tup_max=2 ** 31 // akw["k"] + 1))
    out = dsoft_device_batch(q[:0], qlens[:0], th, tpos, **akw)
    assert [tuple(x.shape) for x in out] == [(0, 256), (0, 256), (0,), (0,)]


def test_dsoft_device_pipeline_on_card(cuda):
    """tiny with --dsoft device under both engines gives the reference
    binary's records; collect_calls_device on the card gives the host
    D-SOFT's calls, and caches the index's device copies."""
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.pipeline import (collect_calls,
                                           collect_calls_device, read_banks)

    params = Params.from_cfg(TINY / "params.cfg")
    reads = parse_fasta(TINY / "reads.fasta")
    want = set((TINY / "out.darwin").read_text().splitlines())
    for engine in ("device", "host"):
        m = {}
        res = run_pipeline(reads, reads, params, True, batch_size=16,
                           engine=engine, dsoft="device", device=cuda,
                           metrics=m)
        assert set(res.records) == want, engine
        assert m["dsoft_overflow_reads"] == 0
    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    merged = SeqBank.concat(*read_banks(reads))
    host = collect_calls(table, genome, merged, params)
    for index in ("auto", "searchsorted", "dense"):
        dev_calls = collect_calls_device(table, genome, merged, params,
                                         index=index, device=cuda)
        for f in ("ref_id", "query_id", "ref_pos", "query_pos"):
            np.testing.assert_array_equal(getattr(dev_calls, f),
                                          getattr(host, f))
    assert len(table._device_index) == 3


def test_checked_library_matches_normal(cuda):
    """chip_smoke.checked_digests at one small input a kernel (the DP in
    every format and plane 2, the three walkers on its output and on
    walk_cases, the fetch pair and one set at both bank ends, SW at its
    edge shapes): a child process on the checked library exits 0 and
    gives the normal library's outputs; a launch past its tensors'
    allocations (chip_smoke.checked_trap) ends another in a trap's
    launch failure."""
    import chip_smoke

    want = chip_smoke.checked_digests(cuda, small=True)
    r = chip_smoke._checked_child("--small")
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == want
    # The control: a launch past its tensors' allocations traps there.
    r = chip_smoke._checked_child("--trap")
    assert chip_smoke.trapped(r), (r.returncode, r.stderr[-3000:])


def test_swscore_kernel_matches_plain(cuda):
    """Score-only SW at B = 64 on ragged related pairs of 200-3000
    bases, under two scorings; lanes 0 and 1 have an empty side."""
    rng = np.random.default_rng(64)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    B, L = 64, 3000
    ref = np.zeros((B, L), np.uint8)
    query = np.zeros((B, L), np.uint8)
    rlen = rng.integers(200, L + 1, size=B).astype(np.int32)
    qlen = rng.integers(200, L + 1, size=B).astype(np.int32)
    rlen[0] = qlen[1] = 0
    for b in range(B):
        src = acgt[rng.integers(0, 4, size=2 * L)]
        q = src[rng.integers(0, L // 2):].copy()
        q[rng.random(len(q)) < 0.1] = acgt[rng.integers(0, 4)]
        ref[b, :rlen[b]] = src[:rlen[b]]
        query[b, :qlen[b]] = q[:qlen[b]]
    t = [torch.from_numpy(x).to(cuda) for x in (ref, query, rlen, qlen)]
    for sc in [(1, -1, -1, -1), (2, -3, -4, -2)]:
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
        n = swscore.local_score_batch.launches
        got = swscore.local_score_batch(*t, **kw)
        assert swscore.local_score_batch.launches == n + 1
        want = swscore.local_score_batch_torch(*t, **kw)
        assert torch.equal(got, want), sc
        assert (got[2:] > 0).all() and not got[:2].any()


@pytest.mark.parametrize("T", [24, 320, 376])
def test_plane2_kernel_matches_plain(cuda, T):
    ref, query, rlen, qlen, _ = _tiles(T + 2, 64, T, cuda)
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    n = plane2.plane2.launches
    got = plane2.plane2(ref, query, rlen, qlen, **kw)
    assert plane2.plane2.launches == n + 1
    want = plane2.plane2_torch(ref, query, rlen, qlen, **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("C", [1, 31, 32, 33, 40, 64, 65, 383, 384, 1023,
                               1024])
def test_scanshift_lowerings_match_cummax(cuda, C):
    """Both lowerings against torch.cummax at B = 96, at B = 37 (no
    multiple of the kernel's 8 rows a block; chip_smoke.scan_edge_input)
    and on rows that start off a 16-byte boundary, at the widths where
    the kernel's columns a lane change (chip_smoke.SCAN_WIDTHS)."""
    import chip_smoke

    x = torch.from_numpy(np.random.default_rng(C).integers(
        -1000, 1000, size=(96, C), dtype=np.int32)).to(cuda)
    edge = chip_smoke.scan_edge_input(C, cuda)
    odd = torch.zeros(edge.numel() + 1, dtype=torch.int32,
                      device=cuda)[1:].view_as(edge)
    odd.copy_(edge)
    for fn in (scanshift.scanshift_shfl, scanshift.scanshift_smem):
        for inp in (x, edge, odd):
            n = fn.launches
            assert torch.equal(fn(inp), scanshift.scanshift_torch(inp)), (
                fn.__name__, inp.shape)
            assert fn.launches == n + 1


def test_dsoft_scratch_follows_the_smem_budget(cuda):
    """dtt_dsoft_scratch_bytes: nothing while tup_max is within the
    shared-memory budget (no large path), the list of deferred reads
    past it, and a scratch area a block past kSmemArrays."""
    import chip_smoke
    from darwin_tpu_torch import _build

    tb = chip_smoke.DSOFT_SMEM_TUPLES
    need = lambda tup_max: _build.host_call(  # noqa: E731
        "dtt_dsoft_scratch_bytes", 920, tup_max, 800, 132)
    assert need(tb) == 0 and need(8) == 0
    assert need(tb + 1) == need(8192) == (4 * 921 + 15) // 16 * 16
    assert need(32768) > 132 * 200 * 1024


@pytest.mark.parametrize("T", [64, 320])
def test_fetch_kernel_matches_plain(cuda, T):
    rng = np.random.default_rng(T)
    bank = torch.from_numpy(rng.integers(65, 91, size=100_000).astype(
        np.uint8)).to(cuda)
    n_bank = bank.shape[0]
    B = 64
    start = rng.integers(-T, n_bank + T, size=B)
    start[:2] = [-10 ** 9, 10 ** 12]
    args = (bank, torch.from_numpy(start).to(cuda),
            torch.from_numpy(rng.integers(0, T + 1, size=B).astype(
                np.int32)).to(cuda),
            torch.from_numpy(rng.random(B) < 0.5).to(cuda))
    n = tile_fetch.fetch_tiles.launches
    got = tile_fetch.fetch_tiles(*args, T=T, pad=PAD_QUERY)
    assert tile_fetch.fetch_tiles.launches == n + 1
    assert torch.equal(got, fetch_tiles_torch(*args, T=T, pad=PAD_QUERY))


@pytest.mark.parametrize("B", [1, 36, 512])
@pytest.mark.parametrize("T", [1, 32, 64, 320, 376, dp.MAX_TILE])
def test_windowed_walker_matches_plain(cuda, T, B):
    """The byte walker (one warp a tile over shared-memory windows)
    against traceback_torch at two early_terminates: on
    chip_smoke.walk_cases lanes (gap runs longer than a window, walks
    across row 0 and column 0, cut-offs on either axis, empty, one-row
    and one-column tiles, clipped starts) and on the DP's dir bytes of
    related tiles (_tiles) under three scorings."""
    import chip_smoke

    rng = np.random.default_rng(T * 7 + B)
    inputs = [[torch.from_numpy(x).to(cuda)
               for x in chip_smoke.walk_case_batch(rng, T, B)]]
    lanes = slice(None, B) if B >= 3 else slice(-B, None)
    ref, query, rlen, qlen, first = (x[lanes] for x in
                                     _tiles(T + B, max(B, 3), T, cuda))
    for sc in SCORINGS[:3]:
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
        out = dp.align_tiles(ref, query, rlen, qlen, **kw)
        inputs.append((out["dir"], rlen, qlen, first, out["max_i"],
                       out["max_j"]))
    for k, args in enumerate(inputs):
        for et in sorted({max(1, T * 5 // 8), T}):
            want = traceback_torch(*args, early_terminate=et)
            n = traceback.traceback.launches
            got = traceback.traceback(*args, early_terminate=et)
            assert traceback.traceback.launches == n + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w), (k, et)


@pytest.mark.parametrize("B", [1, 36, 512])
@pytest.mark.parametrize("T", [1, 24, 64, 320, 376])
def test_fetch_kernels_match_plain_at_bank_ends(cuda, T, B):
    """fetch_tiles and fetch_tile_pair against their plain versions on
    two banks: one whose storage ends at its odd last byte (its last
    chunks cannot take the aligned loads), one padded by device_banks'
    rule; offsets straddling both ends of each bank and far outside it,
    mixed directions, lengths 0..T; and a bank view that starts off a
    16-byte boundary."""
    rng = np.random.default_rng(T * 3 + B)
    gbank = torch.from_numpy(rng.integers(65, 91, size=100_003,
                                          dtype=np.uint8)).to(cuda)
    qn = 77_777
    qpad = np.full(-(-qn // 16) * 16, PAD_QUERY, dtype=np.uint8)
    qpad[:qn - 1] = rng.integers(65, 91, size=qn - 1, dtype=np.uint8)
    qbank = torch.from_numpy(qpad).to(cuda)[:qn]

    def spans(n):
        start = np.where(rng.random(B) < 0.5,
                         rng.integers(-T - 20, 20, size=B),
                         rng.integers(n - T - 20, n + 20, size=B))
        start[:2] = np.array([-10 ** 9, 10 ** 12])[:B]
        start[2:8:2] = rng.integers(0, n, size=len(start[2:8:2]))
        length = rng.integers(0, T + 1, size=B).astype(np.int32)
        return (torch.from_numpy(start).to(cuda),
                torch.from_numpy(length).to(cuda))

    g_start, rl = spans(gbank.shape[0])
    q_start, ql = spans(qn)
    back = torch.from_numpy(rng.random(B) < 0.5).to(cuda)
    n = tile_fetch.fetch_tiles.launches
    for bank in (gbank, qbank, gbank[5:]):
        got = tile_fetch.fetch_tiles(bank, g_start, rl, back, T=T,
                                     pad=PAD_REF)
        assert torch.equal(got, fetch_tiles_torch(bank, g_start, rl, back,
                                                  T=T, pad=PAD_REF))
    pair = (gbank, qbank, g_start, q_start, rl, ql, back)
    kw = dict(T=T, pad_ref=PAD_REF, pad_query=PAD_QUERY)
    got = tile_fetch.fetch_tile_pair(*pair, **kw)
    want = tile_fetch.fetch_tile_pair_torch(*pair, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tile_fetch.fetch_tiles.launches == n + 4


def test_walker_and_fetch_reject_bad_arguments(cuda):
    dirm = torch.zeros((2, 8, 9), dtype=torch.uint8, device=cuda)
    n2 = torch.zeros(2, dtype=torch.int32, device=cuda)
    args = (dirm, n2, n2, n2.bool(), n2, n2)
    for et in (0, -3):
        with pytest.raises(ValueError):
            traceback.traceback(*args, early_terminate=et)
    bank = torch.zeros(64, dtype=torch.uint8, device=cuda)
    kw = dict(T=8, pad_ref=1, pad_query=2)
    with pytest.raises(ValueError):  # B differs between the sets
        tile_fetch.fetch_tile_pair(bank, bank, n2.long(), n2[:1].long(), n2,
                                   n2[:1], n2.bool(), **kw)
    with pytest.raises(ValueError):
        tile_fetch.fetch_tile_pair(bank, bank.cpu(), n2.long(), n2.long(),
                                   n2, n2, n2.bool(), **kw)
    with pytest.raises(ValueError):
        tile_fetch.fetch_tile_pair(bank, bank, n2.long(), n2.long(), n2, n2,
                                   n2.bool(), T=8, pad_ref=1, pad_query=256)


def test_wrappers_reject_bad_arguments(cuda):
    ref, query, rlen, qlen, _ = _tiles(0, 8, 32, cuda)
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    with pytest.raises(TypeError):
        dp.align_tiles(ref, query, rlen.long(), qlen, **kw)
    with pytest.raises(ValueError):
        dp.align_tiles(ref, query, rlen.cpu(), qlen, **kw)
    with pytest.raises(ValueError):
        dp.align_tiles(ref.t().contiguous().t(), query, rlen, qlen, **kw)
    big = torch.zeros((2, dp.MAX_TILE + 1), dtype=torch.uint8, device=cuda)
    n2 = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dp.align_tiles(big, big, n2, n2, **kw)
    for bad in (dict(interleave=3), dict(dir_format="words")):
        with pytest.raises(ValueError):
            dp.align_tiles(ref, query, rlen, qlen, **bad, **kw)
    with pytest.raises(ValueError):  # B = 6 does not divide by 4
        dp.align_tiles(ref[:6], query[:6], rlen[:6], qlen[:6],
                       interleave=4, **kw)
    with pytest.raises(ValueError):
        dp.align_tiles(big, big, n2, n2, interleave=2, **kw)
    with pytest.raises(ValueError):
        scanshift.scanshift_smem(torch.zeros((2, 1025), dtype=torch.int32,
                                             device=cuda))
    with pytest.raises(ValueError):
        tile_fetch.fetch_tiles(torch.zeros(0, dtype=torch.uint8,
                                           device=cuda),
                               n2.long(), n2, n2.bool(), T=8, pad=1)


def test_pipeline_on_card_matches_reference_with_one_sync_per_iteration(
        cuda):
    """tiny end to end on the card: the reference binary's records, and
    the engine loop waits for the device once per iteration (its
    termination check), plus its set-up copies and the final download."""
    params = Params.from_cfg(TINY / "params.cfg")
    reads = parse_fasta(TINY / "reads.fasta")
    res = run_pipeline(reads, reads, params, True, batch_size=4,
                       device=cuda)
    assert set(res.records) == set((TINY / "out.darwin").read_text()
                                   .splitlines())
    res = run_pipeline(reads, reads, params, True, batch_size=16,
                       engine="host", device=cuda)
    assert set(res.records) == set((TINY / "out.darwin").read_text()
                                   .splitlines())

    from darwin_tpu_torch.engine.batch import GactCalls
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.pipeline import collect_calls, read_banks

    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    merged = SeqBank.concat(*read_banks(reads))
    calls = collect_calls(table, genome, merged, params)
    eng = DeviceGactEngine(
        genome, merged, tile_size=params.tile_size,
        early_terminate=params.early_terminate,
        first_tile_score_threshold=params.first_tile_score_threshold,
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_extend=params.gap_extend,
        same_file=True, batch_size=4, device=cuda)
    R = len(reads)
    calls_r = GactCalls(calls.ref_id, calls.query_id % R, calls.ref_pos,
                        calls.query_pos)
    comp = (calls.query_id >= R).astype(np.int32)
    eng.finish(eng.run_async(calls_r, comp, calls.query_id))  # warm-up
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            recs = eng.finish(eng.run_async(calls_r, comp, calls.query_id))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    assert len(recs) > 0 and eng.last_iters >= 100
    # Besides the per-iteration check: 10 set-up uploads of the call
    # tables and 3 downloads in finish().
    assert eng.last_iters <= syncs <= eng.last_iters + 20, syncs


def test_engine_word_formats_on_card(cuda):
    """The device engine in each tb_format on tiny: the records of the
    byte walker, in the same order, each walker launched."""
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.pipeline import collect_calls, read_banks

    params = Params.from_cfg(TINY / "params.cfg")
    reads = parse_fasta(TINY / "reads.fasta")
    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    merged = SeqBank.concat(*read_banks(reads))
    calls = collect_calls(table, genome, merged, params)
    recs = {}
    for fmt, walk in (("bytes", traceback.traceback),
                      ("packed", traceback.traceback_packed),
                      ("packed6", traceback.traceback_packed6)):
        eng = DeviceGactEngine(
            genome, merged, tile_size=params.tile_size,
            early_terminate=params.early_terminate,
            first_tile_score_threshold=params.first_tile_score_threshold,
            match=params.match, mismatch=params.mismatch,
            gap_open=params.gap_open, gap_extend=params.gap_extend,
            same_file=True, batch_size=32, device=cuda, tb_format=fmt)
        n = walk.launches
        recs[fmt] = [tuple(vars(r).values()) for r in eng.run(calls, False)]
        assert walk.launches > n, fmt
    assert recs["bytes"] and recs["packed"] == recs["bytes"]
    assert recs["packed6"] == recs["bytes"]


def test_lab_entry_points_on_card(cuda, capsys):
    """Each lab entry point at a small size on the card: the sweep's
    checks pass, the interleaved sinks agree, and the gather probe's
    CUDA graph gives the eager sink (it raises otherwise)."""
    from darwin_tpu_torch.lab import (geom_sweep, kernel_lab, plane2_probe,
                                      scanshift_probe)

    assert geom_sweep.main(["--config", "64,320,packed6,4",
                            "--config", "32,100,bytes,2"]) == 0
    assert kernel_lab.main(["base", "ilp", "tbiters", "--batch", "64",
                            "--variants", "2"]) == 0
    out = capsys.readouterr().out
    assert "2/2 configs exact" in out
    assert len({ln.split("sink ")[1] for ln in out.splitlines()
                if "interleave=" in ln}) == 1
    emit = plane2_probe.probe_emit(24, cuda, B=64, V=2, reps=1)
    assert emit["packed6 base"][1] == plane2_probe.probe_emit(
        24, torch.device("cpu"), B=64, V=2, reps=1)["packed6 base"][1]
    gather = plane2_probe.probe_gather(24, cuda, B=64, V=2, reps=1)
    cpu = plane2_probe.probe_gather(24, torch.device("cpu"), B=64, V=2,
                                    reps=1)
    for mode, (graph_ms, _, sink) in gather.items():
        assert graph_ms is not None and sink == cpu[mode][2], mode
    scan = scanshift_probe.run(376, cuda, B=64, V=2, reps=1)
    assert scan["shfl"][1] == scan["smem"][1]


@pytest.mark.parametrize("name", list(chip_smoke.SHARDED_CASES))
def test_table_sharded_kernels_match_plain(cuda, name):
    """shard_scan and shard_count on every shard of chip_smoke's cases
    (8 entries of cuda:0), each index mode and exchange, equal to their
    plain versions, and the whole function to dsoft_table_sharded_torch."""
    from darwin_tpu_torch.dsoft import sharded_table as st

    mesh, q, lens, shards, kw, a2a, over, _, _ = \
        chip_smoke.sharded_case_args(name, cuda)
    calls = []
    steps = (chip_smoke._checking(st.shard_scan, st.shard_scan_torch, calls),
             chip_smoke._checking(st.shard_count, st.shard_count_torch,
                                  calls))
    for index in ("dense", "searchsorted"):
        for cap, flagged in zip((a2a, None), over):
            args = (mesh, q, lens, shards)
            ekw = dict(kw, a2a_cap=cap, index=index)
            got = st.dsoft_table_sharded(*args, steps=steps, **ekw)
            want = st.dsoft_table_sharded_torch(*args, **ekw)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            assert bool(got[3].any()) == flagged
    assert len(calls) == 4 * 2 * chip_smoke.SHARDED_P


@pytest.mark.parametrize("index", ["dense", "searchsorted"])
@pytest.mark.parametrize("name", list(chip_smoke.SHARDED_CASES))
def test_shard_scan_kernel_matches_plain(cuda, name, index):
    """shard_scan on every shard of chip_smoke's cases equals its plain
    version (tolerance 0), the reads padded to each L % 4 (the kernel's
    vector stores take LP % 4 == 0, else a position at a time); under the
    dense index also with fewer refine steps than its widest bucket
    needs (the kernel's truncated search)."""
    from darwin_tpu_torch.dsoft import sharded_table as st

    _, q, lens, shards, kw, *_ = chip_smoke.sharded_case_args(name, cuda)
    steps = kw["dense_steps"]
    runs = [(pad, steps) for pad in range(4)]
    if index == "dense":
        runs += [(0, s) for s in range(steps)]
    for pad, s in runs:
        qp = torch.nn.functional.pad(q, (0, pad))
        skw = dict(k=kw["k"], w=kw["w"], index=index, dense_steps=s)
        for th, _, di in shards:
            got = st.shard_scan(qp, lens, th, di, **skw)
            for g, w in zip(got, st.shard_scan_torch(qp, lens, th, di,
                                                     **skw)):
                assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(chip_smoke.SHARD_COUNT_CASES))
def test_shard_count_kernel_matches_plain_on_edge_cases(cuda, name):
    """shard_count on chip_smoke's synthetic cases (reads at each form's
    edges and past the shared-memory budget) equals its plain version
    (tolerance 0), also when captured in a CUDA graph: its wrapper makes
    no host sync."""
    from darwin_tpu_torch.dsoft import sharded_table as st

    args, kw = chip_smoke.shard_count_case_args(name, cuda)
    want = st.shard_count_torch(*args, **kw)
    for g, w in zip(st.shard_count(*args, **kw), want):
        assert torch.equal(g, w)
    graph, out = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        out.append(st.shard_count(*args, **kw))
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(out[0], want):
        assert torch.equal(g, w)


def test_mesh_paths_on_card(cuda, tmp_path):
    """The sharded engine and aligner over two cuda:0 entries equal the
    one-device ones on tiny; the CLI's --mesh 1 gives the fixture's
    records, --mesh past the visible devices fails."""
    from darwin_tpu_torch import cli
    from darwin_tpu_torch.parallel.mesh import make_mesh

    base = ["--params", str(TINY / "params.cfg"), "--batch-size", "64"]
    fa = str(TINY / "reads.fasta")
    assert cli.main([fa, fa, *base, "--mesh", "1", "--out-dir",
                     str(tmp_path), "--merged-out",
                     str(tmp_path / "m")]) == 0
    assert (tmp_path / "m").read_text().splitlines() == sorted(
        set((TINY / "out.darwin").read_text().splitlines()))
    n = torch.cuda.device_count()
    assert cli.main([fa, fa, *base, "--mesh", str(n + 1)]) == 2
    with pytest.raises(RuntimeError, match=f"{n} visible"):
        make_mesh(n + 1)
    params = Params.from_cfg(TINY / "params.cfg")
    reads = parse_fasta(TINY / "reads.fasta")
    mesh = make_mesh(devices=[cuda] * 2)
    from darwin_tpu_torch.pipeline import (format_records, make_merged_engine,
                                           read_banks, run_device_merged)
    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size)
    fwd, rev = read_banks(reads)
    got = {}
    for m in (None, mesh):
        pre = make_merged_engine(genome, fwd, rev, params, same_file=True,
                                 batch_size=64, device=cuda, mesh=m)
        recs, _ = run_device_merged(genome, table, fwd, rev, params,
                                    same_file=True, batch_size=64,
                                    prebuilt=pre)
        got[m is None] = set(format_records(genome, reads, recs))
    assert got[True] == got[False] == set(
        (TINY / "out.darwin").read_text().splitlines())


def test_drain_on_card_with_one_sync_per_iteration(cuda):
    """tools/torch_drain_prof.py's skewed workload on the card: under
    auto the gate engages and a second tier runs; the records are drain
    off's set, with the same iterations and active slot-iterations; the
    loop waits for the device once an iteration in both tiers."""
    dp = chip_smoke._drain_prof()
    genome, bank, calls = dp.skewed_workload()
    eng = dp.make_engine(genome, bank, cuda)
    eng.drain = False
    off = eng.finish(eng.run_async(calls, False))
    off_counts = (eng.last_iters, eng.last_active_sum)
    assert eng.last_drain_redispatches == 0
    eng.drain = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            recs = eng.finish(eng.run_async(calls, False))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    assert gate_engages(*eng.last_drain_gate)
    assert eng.last_drain_redispatches == 1
    assert (eng.last_iters, eng.last_active_sum) == off_counts
    assert dp.record_set(recs) == dp.record_set(off) and recs
    # Besides the per-iteration check: each tier's set-up uploads and
    # downloads, and the first tier's state.
    assert eng.last_iters <= syncs <= eng.last_iters + 40, syncs


def _slot_loop_engine(genome, bank, dev, **kw):
    return DeviceGactEngine(
        genome, bank, tile_size=chip_smoke.SLOT_LOOP_T,
        early_terminate=chip_smoke.SLOT_LOOP_ET,
        first_tile_score_threshold=chip_smoke.SLOT_LOOP_THRESHOLD, match=1,
        mismatch=-1, gap_open=-1, gap_extend=-1, batch_size=64, device=dev,
        **kw)


def _same_loop_out(a, b):
    assert (a.nrec, a.iters, a.act_sum, a.calls_done) == \
        (b.nrec, b.iters, b.act_sum, b.calls_done)
    assert torch.equal(a.records[:a.nrec], b.records[:b.nrec])
    assert (a.state is None) == (b.state is None)
    if a.state is not None:
        assert torch.equal(a.state, b.state)


@pytest.mark.parametrize("fmt", ["bytes", "packed", "packed6"])
@pytest.mark.parametrize("same_file", [False, True])
@pytest.mark.parametrize("score", [True, False])
@pytest.mark.parametrize("n_calls,drain", [(40, 0), (300, 0), (300, 16)])
def test_fused_slot_loop_equals_torch_loop(cuda, fmt, same_file, score,
                                           n_calls, drain):
    """The engine loop on the card with its bookkeeping in csrc/
    slot_loop.cu (_loop, which takes _loop_fused there) against the
    PyTorch loop (_loop_torch) from the same state, on
    chip_smoke.slot_loop_workload (anchors at 0 and at a read's and a
    piece's end, calls that fail the first tile's threshold), N below
    and above the 64 slots: the records in order, their count,
    iterations, active slot-iterations, calls done and the exported
    state, each slot_loop kernel launched once an iteration.  Where the
    drain stops the first tier, the second tier resumed from its state
    is the same too."""
    from darwin_tpu_torch.ops import slot_loop

    genome, bank, meta, cstate = chip_smoke.slot_loop_workload(3, n_calls)
    eng = _slot_loop_engine(genome, bank, cuda, tb_format=fmt,
                            same_file=same_file, compute_score=score)
    want = eng._loop_torch(meta, cstate, drain)
    n = slot_loop.slot_prepare.launches, slot_loop.slot_post.launches
    got = eng._loop(meta, cstate, drain)
    _same_loop_out(got, want)
    assert (slot_loop.slot_prepare.launches - n[0],
            slot_loop.slot_post.launches - n[1]) == (got.iters, got.iters)
    assert got.spans["engine_fused_iters"] == got.iters > 0
    assert want.spans["engine_fused_iters"] == 0
    if drain:
        assert 0 < got.calls_done < n_calls
        state = got.state.cpu().numpy()
        idx = np.flatnonzero(state[:, 8] == 0)
        rest = tuple(m[idx] for m in meta)
        _same_loop_out(eng._loop(rest, state[idx], 0),
                       eng._loop_torch(rest, state[idx], 0))
    else:
        assert got.calls_done == n_calls and got.nrec > 0


@pytest.mark.parametrize("T,et", [(376, 256), (320, 200)])
def test_bench_step_matches_plain(cuda, T, et):
    """darwin_tpu_torch.bench's step sink from the kernels equals the
    plain versions' at both of its geometries."""
    from darwin_tpu_torch import bench

    b = bench.Batches(cuda, 64, T, 2)
    for v in range(2):
        assert int(bench.one_step(b, v, et)) == int(
            bench.one_step(b, v, et, plain=True))


@pytest.mark.parametrize("kind", ["random 5 Mb", "ecoli_shape",
                                  "guided_shape"])
def test_seed_table_kernels_match_plain_and_native(cuda, kind, tmp_path):
    """The seed table's kernels (csrc/seed_table.cu) on a random 5 Mb
    genome and on the genomes of tests/data/ecoli_shape and guided_shape
    at the default k and w: scan and sort equal their plain versions and
    the native build bit for bit, and each wrapper counts one launch."""
    from darwin_tpu_torch.index import table_device as td

    if kind == "guided_shape":
        st = chip_smoke._tool("torch_scale_test")
        st.make_dataset(st.parse_args([*chip_smoke.GUIDED_SHAPE_FLAGS,
                                       "--workdir", str(tmp_path)]),
                        tmp_path)
        g = Genome(parse_fasta(tmp_path / "genome.fasta"),
                   Params().bin_size).concat
    else:
        g = chip_smoke.table_genome(kind)
    params = Params()
    n0, s0 = td.minimizer_keys.launches, td.sort_keys.launches
    n = chip_smoke.table_check(g, params.seed_size, params.window_size, cuda)
    assert n > len(g) // 4
    # table_check launches each twice: alone, then in table_arrays.
    assert (td.minimizer_keys.launches, td.sort_keys.launches) == (
        n0 + 2, s0 + 2)


@pytest.mark.parametrize("k,w", [(14, 4), *chip_smoke.TABLE_EDGE_KW])
def test_seed_table_kernels_at_the_edges(cuda, k, w):
    """Every edge genome (tile edges, the single-thread threshold, runs
    of one base and of N over several tiles, lowercase) at k, w."""
    for _, g in chip_smoke.table_edge_genomes():
        chip_smoke.table_check(g, k, w, cuda)


def test_run_pipeline_builds_the_seed_table_on_the_card(cuda):
    """run_pipeline on the E.coli slice builds its table with the
    kernels (table_device 1, each wrapper launched once) and gives the
    oracle's records."""
    from darwin_tpu_torch.index import table_device as td
    from darwin_tpu_torch.io.fasta import FastaRecord

    reads = [FastaRecord([n], s) for n, s in chip_smoke.ecoli_reads()]
    want = (REPO / "tests" / "data" / "ecoli_shape" /
            "jax_cpu.darwin").read_text().splitlines()
    n0, s0 = td.minimizer_keys.launches, td.sort_keys.launches
    m = {}
    res = run_pipeline(reads, reads, Params(), True, batch_size=512,
                       device=cuda, metrics=m)
    assert sorted(set(res.records)) == want
    assert m["table_device"] == 1
    assert (td.minimizer_keys.launches, td.sort_keys.launches) == (
        n0 + 1, s0 + 1)


def test_resident_genome_bank_gives_a_fresh_uploads_records(cuda, tmp_path):
    """guided_shape's reads in two batches through run_device_merged
    with the device D-SOFT against one Genome, as the CLI's chunk loop
    runs them: the genome's bank is uploaded with the first batch's
    engine and kept (genome_bank_uploads 1, then 0); each batch's
    records equal those of an engine over a fresh upload (a new
    Genome), and the batches' together the oracle's."""
    from darwin_tpu_torch.pipeline import (format_records, read_banks,
                                           run_device_merged)

    st = chip_smoke._tool("torch_scale_test")
    st.make_dataset(st.parse_args([*chip_smoke.GUIDED_SHAPE_FLAGS,
                                   "--workdir", str(tmp_path)]), tmp_path)
    want = (REPO / "tests" / "data" / "guided_shape" /
            "jax_cpu.darwin").read_text().splitlines()
    params = Params()
    ref = parse_fasta(tmp_path / "genome.fasta")
    reads = parse_fasta(tmp_path / "reads.fasta")
    genome = Genome(ref, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size, device=cuda)
    kw = dict(same_file=False, batch_size=4096, dsoft="device", device=cuda)
    half = len(reads) // 2
    uploads, lines = [], []
    for batch in (reads[:half], reads[half:]):
        got = {}
        for g in (genome, Genome(ref, params.bin_size)):
            m = {}
            recs, _ = run_device_merged(g, table, *read_banks(batch), params,
                                        metrics=m, **kw)
            got[g is genome] = sorted(format_records(g, batch, recs))
            if g is genome:
                uploads.append(m["genome_bank_uploads"])
            else:
                assert m["genome_bank_uploads"] == 1
        assert got[True] == got[False] and got[True]
        lines += got[True]
    assert uploads == [1, 0]
    assert sorted(set(lines)) == want
