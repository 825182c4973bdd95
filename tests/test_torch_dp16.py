"""The 16-bit split DP's gate and dispatch, on the CPU.

* the port's copy of darwin_tpu's 16-bit sentinel and of its bound on
  the scores (pallas_dp.py NEG16, _score_dtype), and the gate built on
  them (ops/dp.py fits_int16), at its edges;
* which kernel, warps a tile and columns a lane ops/dp.py picks for the
  split path's tile sizes, inside and outside the gate;
* a numpy int64 DP of the state extrema over worst-case tiles at the
  gate's edge (T = 2048): what the 16-bit kernel holds stays inside
  int16 and clear of the sentinel.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
All values are integers: the tolerance is 0.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from darwin_tpu.ops import pallas_dp
from darwin_tpu_torch.ops import dp

DEFAULT = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
KEYS = ("match", "mismatch", "gap_open", "gap_extend")


def _scoring(sc):
    return dict(zip(KEYS, sc))


def state_extrema(ref, query, match, mismatch, gap_open, gap_extend):
    """(least, largest) of H, M + go, I + ge and D + ge over the cells
    1..len(ref) x 1..len(query) of the tile DP, in int64, row by row
    (the query gap in the closed form reference_dp.py uses); the
    sentinels of row 0 and column 0 are left out."""
    R, Q = len(ref), len(query)
    neg = -(1 << 40)
    j = np.arange(Q + 1, dtype=np.int64)
    h_prev = np.zeros(Q + 1, np.int64)
    m_prev = np.zeros(Q + 1, np.int64)
    i_prev = np.full(Q + 1, neg, np.int64)
    lo, hi = 0, 0
    for r in range(1, R + 1):
        s = np.where(query == ref[r - 1], match, mismatch).astype(np.int64)
        m = np.zeros(Q + 1, np.int64)
        m[1:] = np.maximum(h_prev[:-1] + s, 0)
        ii = np.maximum(m_prev + gap_open, i_prev + gap_extend)
        ii[0] = neg
        # D[j] = max over l < j of M[l] + go + (j - 1 - l) ge.
        c = np.maximum.accumulate(m + gap_open - j * gap_extend)
        d = np.full(Q + 1, neg, np.int64)
        d[1:] = c[:-1] + (j[1:] - 1) * gap_extend
        h = np.maximum(np.maximum(m, ii), d)
        for v in (h, m + gap_open, ii + gap_extend, d + gap_extend):
            lo, hi = min(lo, int(v[1:].min())), max(hi, int(v[1:].max()))
        h_prev, m_prev, i_prev = h, m, ii
    return lo, hi


def worst_tiles(T):
    """Identical full tiles (the largest H), all-mismatch full tiles
    (every M 0, the gaps' least values) and a long gap: the query is
    the ref with its middle third deleted, then padding."""
    rng = np.random.default_rng(T)
    ref = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, T)]
    gap = np.concatenate([ref[:T // 3], ref[2 * T // 3:]])
    return {"identical": (ref, ref.copy()),
            "mismatch": (np.full(T, ord("A"), np.uint8),
                         np.full(T, ord("C"), np.uint8)),
            "long gap": (ref, gap)}


def test_neg16_and_the_bound_are_darwin_tpus():
    """NEG16 is darwin_tpu's sentinel; where no gap scores above 0 the
    bound is the one _score_dtype states, (T + 2) * max|param|."""
    assert dp.NEG16 == pallas_dp.NEG16 == -20000
    assert "(T+2) * max|param|" in pallas_dp._score_dtype.__doc__
    for T in (1, 1024, 2048):
        for sc in ((1, -1, -1, -1), (2, -3, -4, -2), (3, -1, -2, -1),
                   (2, 1, -3, -1), (9, -9, -9, 0)):
            assert dp.score_bound(T, **_scoring(sc)) == (T + 2) * max(
                map(abs, sc))


@pytest.mark.parametrize("T,sc,ok", [
    (2048, (1, -1, -1, -1), True), (2048, (9, -1, -1, -1), True),
    (2048, (10, -1, -1, -1), False), (2048, (1, -9, -9, -9), True),
    (2048, (1, -10, -1, -1), False), (1024, (19, -19, -19, -19), True),
    (1024, (20, -1, -1, -1), False), (2221, (9, -9, -9, -9), False),
    (2220, (9, -9, -9, -9), True), (2048, (4, -1, 4, 1), True),
    (2048, (5, -1, 5, 1), False), (2048, (1, -1, 1, -1), True),
    (4998, (2, -1, -1, 2), True), (4999, (2, -1, -1, 2), False)])
def test_gate_at_its_edges(T, sc, ok):
    """fits_int16 holds exactly while score_bound stays below -NEG16:
    at T = 2048 up to max|param| 9 with no positive gap score (10 is one
    step past), up to 4 with one ((2T + 2) x 4 = 16392, x 5 = 20490)."""
    kw = _scoring(sc)
    assert dp.fits_int16(T, **kw) is ok
    assert (dp.score_bound(T, **kw) < -dp.NEG16) is ok


@pytest.mark.parametrize("T,strips,width", [
    (1024, 2, 16), (1025, 2, 24), (1536, 2, 24), (1537, 4, 16),
    (2047, 4, 16), (2048, 4, 16)])
def test_dispatch_inside_the_gate(T, strips, width):
    """At the default scoring every split tile size goes to the 16-bit
    kernel in each format at interleave 1 (counted on
    align_tiles.split16), at the warps a tile and columns a lane
    strips_for and check_strips pick for it (two warps up to 1536, four
    past it); interleaved and plane 2 launches stay on the int32 split
    kernel."""
    assert dp.strips_for(T, 1, dp16=True) == strips
    assert dp.check_strips(T, 1, strips, "test", dp16=True) == width
    for fmt in dp.SPLIT16_FORMATS:
        assert dp.takes_int16(T, fmt, 1, dp.strips_for(T, 1), **DEFAULT)
        assert dp.kernel_counter(T, fmt, 1, **DEFAULT) is \
            dp.align_tiles.split16
    assert not dp.takes_int16(T, "plane2", 1, strips, **DEFAULT)
    for il in (2, 4):
        assert not dp.takes_int16(T, "bytes", il, dp.strips_for(T, il),
                                  **DEFAULT)
        assert dp.kernel_counter(T, "bytes", il, **DEFAULT) is \
            dp.align_tiles.split


@pytest.mark.parametrize("T", [1024, 1025, 1536, 2047, 2048])
def test_dispatch_outside_the_gate(T):
    """A scoring past the gate (max|param| 20) runs the int32 split
    kernel at its own warps a tile and widths (S = ceil(T / 512), C of
    8, 12, 16); the one-warp sizes never reach either split kernel."""
    kw = dict(match=20, mismatch=-20, gap_open=-20, gap_extend=-20)
    strips = dp.strips_for(T, 1)
    assert strips == -(-T // 512)
    assert not dp.takes_int16(T, "bytes", 1, strips, **kw)
    assert dp.kernel_counter(T, "packed6", 1, **kw) is dp.align_tiles.split
    assert dp.check_strips(T, 1, strips, "test") in dp.SPLIT_WIDTHS[1]
    assert dp.kernel_counter(1023, "bytes", 1, **DEFAULT) is dp.align_tiles
    assert not dp.takes_int16(1023, "bytes", 1, 1, **DEFAULT)


@pytest.mark.parametrize("T,strips,width", [
    (2048, 3, 24), (1536, 2, 24), (1537, 3, 24), (1023, 8, 16),
    (1023, 3, 16), (320, 2, 16), (2048, 2, None), (1537, 2, None)])
def test_forced_16bit_widths(T, strips, width):
    """Forced warps a tile (the lab's sweep, the card tests) take the
    least 16-bit width, 16 or 24, that covers T: two warps stop at T =
    1536."""
    if width is None:
        with pytest.raises(ValueError, match="warps a tile"):
            dp.check_strips(T, 1, strips, "test", dp16=True)
        return
    assert dp.check_strips(T, 1, strips, "test", dp16=True) == width
    assert dp.takes_int16(T, "bytes", 1, strips, **DEFAULT)


@pytest.mark.parametrize("sc", [(1, -1, -1, -1), (9, -9, -9, -9),
                                (9, -9, -1, 0), (4, -1, 4, 4),
                                (4, 4, -4, 4)])
def test_state_stays_clear_of_the_sentinel_at_the_edge(sc):
    """At T = 2048, on identical, all-mismatch and long-gap tiles, every
    state value the kernel keeps (H, M + go, I + ge, D + ge) lies within
    score_bound and above -2 max|param|, and so strictly between the
    sentinel's NEG16 + gap_extend and -NEG16, inside int16; the sentinel
    itself stays in int16 too."""
    T = 2048
    kw = _scoring(sc)
    assert dp.fits_int16(T, **kw)
    bound = dp.score_bound(T, **kw)
    p = max(map(abs, sc))
    floor = dp.NEG16 + kw["gap_extend"]
    assert -(1 << 15) <= floor
    for name, (ref, query) in worst_tiles(T).items():
        lo, hi = state_extrema(ref, query, **kw)
        assert -2 * p <= lo and hi <= bound < -dp.NEG16, (name, lo, hi)
        assert floor < kw["gap_open"] and floor < lo, (name, lo)


def test_one_step_past_the_edge_leaves_the_bound():
    """One step past the gate (max|param| 10 at T = 2048) the identical
    tile's H passes -NEG16 and the gate refuses the scoring; a gap score
    above 0 doubles the reach (all +1 at T = 12 reaches 23 > (T + 2))."""
    T = 2048
    kw = dict(match=10, mismatch=-10, gap_open=-10, gap_extend=-10)
    ref, query = worst_tiles(T)["identical"]
    assert state_extrema(ref, query, **kw)[1] >= -dp.NEG16
    assert not dp.fits_int16(T, **kw)
    ref = np.frombuffer(b"ACAACCAACAAC", np.uint8)
    kw = dict(match=1, mismatch=1, gap_open=1, gap_extend=1)
    hi = state_extrema(ref, ref[::-1].copy(), **kw)[1]
    assert len(ref) + 2 < hi <= dp.score_bound(len(ref), **kw)


def test_sass_row_body_counts_a_synthetic_listing():
    """tools/torch_sass_cells.py on a made-up cuobjdump listing: the row
    body is the straight-line block with the most DPX instructions, its
    cells C (int32 kernel) or 2C (16-bit kernel) a lane-row."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import torch_sass_cells as sc

    def insn(n, op):
        return f"        /*{16 * n:04x}*/                   {op} ;"

    body = ["VIADDMNMX.S16x2 R1, R2, R3, R4", "VIMNMX3.U16x2 R1, R2, R3, R4",
            "LOP3.LUT R1, R2, R3, RZ, 0x3c, !PT", "@P0 STS [R1], R2"] * 4
    ops = (["S2R R0, SR_TID.X", "VIMNMX3 R1, R2, R3, R4", "BRA 0x40"] + body
           + ["BAR.SYNC.DEFER_BLOCKING 0x0", "IADD3 R1, R1, 0x1, RZ", "EXIT"])
    name = "_ZN37_GLOBAL__N_" + sc.mangled("split16", 4, "bytes") + "vNS_4ArgsE"
    listing = ("\n\tFunction : " + name + "\n" +
               "\n".join(insn(n, op) for n, op in enumerate(ops)) + "\n")
    report = ("ptxas info    : Compiling entry function '" + name +
              "' for 'sm_90a'\nptxas info    : Function properties\n"
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill"
              " loads\nptxas info    : Used 99 registers\n")
    (row,) = sc.count(listing, ["split16:4:bytes"], report)
    assert (row["instructions"], row["cells"], row["function"]) == (16, 8,
                                                                     len(ops))
    assert row["per_cell"] == 2.0
    assert (row["registers"], row["spill_stores"]) == (99, 0)
    with pytest.raises(SystemExit, match="no kernel"):
        sc.count(listing, ["split:16:bytes"], report)


def test_split_sweep_runs_on_the_cpu(capsys):
    """The lab's split sweep on the CPU runs each config's plain version
    once (the card times both kernels at each warps a tile)."""
    from darwin_tpu_torch.lab import split_sweep

    assert split_sweep.main(["--device", "cpu", "--tiles", "24",
                             "--batches", "4", "--strips", "2"]) == 0
    out = capsys.readouterr().out
    assert "B=4 T=24 bytes plain" in out and "2/2 runs exact" in out
