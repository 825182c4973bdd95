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
import torch

from darwin_tpu.ops import pallas_dp
from darwin_tpu_torch import _build
from darwin_tpu_torch.ops import dp, plane2

DEFAULT = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
OUTSIDE16 = dict(match=40, mismatch=-30, gap_open=-64, gap_extend=-20)
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
    kernel in each format and plane 2 at interleave 1 and in each format
    at 2 and 4 (counted on align_tiles.split16), bytes at the warps a
    tile and columns a lane strips_for and check_strips pick for it (two
    warps up to 1536, four past it), the same at every interleave (one
    kernel, a pair of tiles a lane); SPLIT16_SLOWER is where the gate
    keeps a shape on the int32 kernel instead."""
    assert dp.strips_for(T, 1, dp16=True) == strips
    assert dp.check_strips(T, 1, strips, "test", dp16=True) == width
    for fmt in dp.SPLIT16_FORMATS:
        for il in (1,) if fmt == "plane2" else dp.INTERLEAVES:
            slower = any(lo <= T <= hi for lo, hi in
                         dp.SPLIT16_SLOWER.get((fmt, il), ()))
            assert dp.takes_int16(T, fmt, il, dp.strips_for(T, il),
                                  **DEFAULT) is not slower
            p = dp.plan(T, fmt, il, **DEFAULT)
            assert p.kernel == (dp.SPLIT if slower else dp.SPLIT16)
            if fmt != "plane2":
                assert dp.kernel_counter(T, fmt, il, **DEFAULT) is (
                    dp.align_tiles.split if slower
                    else dp.align_tiles.split16)
            if p.kernel == dp.SPLIT16:
                assert p == dp.plan(T, fmt, 1, dp16=True, **DEFAULT)
    assert not dp.runs_int16(T, "plane2", 2, **DEFAULT)


@pytest.mark.parametrize("T,sc,ok", [
    (2048, (9, -9, -9, -9), True), (2048, (10, -1, -1, -1), False),
    (1997, (10, -1, -1, -1), True), (1998, (10, -1, -1, -1), False),
    (385, (51, -1, -1, -1), True), (385, (52, -1, -1, -1), False),
    (512, (4, -1, 4, 1), True), (2048, (5, -1, 5, 1), False)])
def test_gate_at_its_edges_interleaved_and_plane2(T, sc, ok):
    """At interleave 2 and 4 and for plane 2 the gate is fits_int16 at
    its edges, as at interleave 1: inside it the 16-bit kernel (where
    SPLIT16_SLOWER does not keep the int32 one), one step past it the
    int32 split kernel; plane 2 only
    past the one-warp sizes of interleave 1."""
    kw = _scoring(sc)
    assert dp.fits_int16(T, **kw) is ok
    for fmt, il in (("bytes", 2), ("packed6", 4), ("packed", 4),
                    ("plane2", 1)):
        split = T > dp.ONE_WARP_TILE[il]
        slower = any(lo <= T <= hi for lo, hi in
                     dp.SPLIT16_SLOWER.get((fmt, il), ()))
        p = dp.plan(T, fmt, il, **kw)
        assert dp.runs_int16(T, fmt, il, **kw) is ok
        assert dp.takes_int16(T, fmt, il, dp.strips_for(T, il), **kw) is (
            ok and split and not slower)
        assert p.kernel == (dp.ONE_WARP if not split else
                            dp.SPLIT16 if ok and not slower else dp.SPLIT)


def test_forced_16bit_outside_the_gate_raises():
    """Forcing the 16-bit kernel (dp16=True) raises outside runs_int16: a
    scoring past the gate, plane 2 interleaved; dp16=False never reaches
    it; a forced width must be one the kernel instantiates."""
    for T in (385, 1024, 2048):
        for fmt, il in (("bytes", 1), ("packed6", 2), ("bytes", 4)):
            with pytest.raises(ValueError, match="16-bit"):
                dp.plan(T, fmt, il, dp16=True, **OUTSIDE16)
            assert dp.plan(T, fmt, il, dp16=False, **OUTSIDE16).kernel in (
                dp.ONE_WARP, dp.SPLIT)
    with pytest.raises(ValueError, match="16-bit"):
        dp.plan(1024, "plane2", 2, dp16=True, **DEFAULT)
    with pytest.raises(ValueError, match="width"):
        dp.plan(1024, "bytes", 1, dp16=True, width=8, **DEFAULT)
    with pytest.raises(ValueError, match="width"):
        dp.plan(1024, "packed6", 1, dp16=True, width=24, **DEFAULT)
    assert dp.plan(1024, "bytes", 1, dp16=True, width=24,
                   **DEFAULT) == (dp.SPLIT16, 2, 24)


@pytest.fixture
def meta_launches(monkeypatch):
    """run_kernel on meta tensors: the device check passes them and
    _build.launch records (entry, arguments) instead of calling the
    library, so the dispatch and the counting run as on the card."""
    calls = []
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: t.device)
    monkeypatch.setattr(_build, "launch",
                        lambda entry, dev, *args: calls.append((entry,
                                                                args)))
    return calls


@pytest.mark.parametrize("T", [385, 512, 1023, 1024, 2048])
@pytest.mark.parametrize("sc", [(1, -1, -1, -1), (9, -9, -9, -9),
                                (10, -1, -1, -1), (40, -30, -64, -20)])
def test_counter_names_the_kernel_launched(meta_launches, T, sc):
    """Over (T, format, interleave, scoring): align_tiles and plane2
    count each launch on the counter of the kernel run_kernel reports,
    which is the C entry it called (dtt_align_tiles16: the 16-bit split
    kernel; dtt_align_tiles over one warp a tile: the one-warp kernel,
    over more: the int32 split kernel) and plan's choice: never another
    counter."""
    kw = _scoring(sc)
    B = 8
    args = ([torch.empty((B, T), dtype=torch.uint8, device="meta")] * 2
            + [torch.empty(B, dtype=torch.int32, device="meta")] * 2)
    seen = set()
    for fmt in (*dp.PACKERS, "plane2"):
        for il in (1,) if fmt == "plane2" else dp.INTERLEAVES:
            counters = plane2.COUNTERS if fmt == "plane2" else dp.COUNTERS
            before = {k: c.launches for k, c in counters.items()}
            meta_launches.clear()
            if fmt == "plane2":
                plane2.plane2(*args, **kw)
            else:
                n = dp.align_tiles.split16.variant_launches[(fmt, il)]
                dp.align_tiles(*args, dir_format=fmt, interleave=il, **kw)
            ((entry, a),) = meta_launches
            kernel = (dp.SPLIT16 if entry == "dtt_align_tiles16" else
                      dp.ONE_WARP if a[13] == 1 else dp.SPLIT)
            moved = {k for k, c in counters.items()
                     if c.launches != before[k]}
            assert moved == {kernel}, (fmt, il)
            assert counters[kernel].launches == before[kernel] + 1
            assert kernel == dp.plan(T, fmt, il, **kw).kernel, (fmt, il)
            if fmt != "plane2":
                assert dp.kernel_counter(T, fmt, il, **kw) is \
                    counters[kernel]
                assert dp.align_tiles.split16.variant_launches[
                    (fmt, il)] == n + (kernel == dp.SPLIT16)
            seen.add(kernel)
    inside = dp.fits_int16(T, **kw)
    assert (dp.SPLIT16 in seen) is inside
    assert (dp.ONE_WARP in seen) is (T <= dp.ONE_WARP_TILE[1])


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
    once, at every interleave it is asked for and in plane 2 (the card
    times both kernels at each warps a tile, width and emitter)."""
    from darwin_tpu_torch.lab import split_sweep

    assert split_sweep.main(["--device", "cpu", "--tiles", "24",
                             "--batches", "4", "--strips", "2",
                             "--formats", "bytes,plane2",
                             "--interleave", "1,2,4"]) == 0
    out = capsys.readouterr().out
    for line in ("B=4 T=24 bytes il=1 plain", "B=4 T=24 bytes il=4 plain",
                 "B=4 T=24 plane2 il=1 plain", "4/4 runs exact"):
        assert line in out
    assert "plane2 il=2" not in out


def test_split_sweep_times_every_instantiated_launch():
    """The launches the sweep times on the card at T = 1024: the int32
    kernel at each S from 2 and each width covering T, the 16-bit one at
    each S from 1 and each width it instantiates (24 in bytes alone) whose
    shared memory fits a block (not C = 24 over eight warps), every one of
    them a launch plan accepts."""
    from darwin_tpu_torch.lab import split_sweep

    got = split_sweep.variants(1024, "packed6", 1, (1, 2, 3, 4))
    assert ("int32", False, 2, 16) in got and ("int32", False, 3, 12) in got
    assert all(not (k == "int32" and S == 1) for k, _, S, _ in got)
    assert {(S, C) for k, _, S, C in got if k == "int16"} == {
        (2, 16), (3, 16), (4, 16)}
    assert ("int16", True, 2, 24) in split_sweep.variants(
        1024, "bytes", 1, (2,))
    il4 = split_sweep.variants(1024, "bytes", 4, (2, 4, 8))
    assert [(k, S, C) for k, _, S, C in il4 if k != "int32"] == [
        ("int16", 2, 16), ("int16", 2, 24), ("int16", 4, 16),
        ("int16", 4, 24), ("int16", 8, 16)]
    p2 = split_sweep.variants(1024, "plane2", 1, (2, 4))
    assert [(k, S, C) for k, _, S, C in p2 if k == "int16"] == [
        ("int16", 2, 16), ("int16", 4, 16)]
    for fmt, il, rows in (("packed6", 1, got), ("bytes", 4, il4),
                          ("plane2", 1, p2)):
        for _, dp16, S, C in rows:
            assert dp.plan(1024, fmt, il, strips=S, dp16=dp16, width=C,
                           **DEFAULT).width == C


def test_split_smem_matches_the_kernels_budgets():
    """split_smem follows the kernels' formulas: the int32 kernel at four
    tiles a block in packed6 at T = 2048 over eight warps of C = 8 takes
    208,384 bytes (csrc/dp.cu split_smem), the 16-bit one in bytes at C =
    24 over eight warps passes the card's 227 KB, so plan refuses it, and
    over four warps it fits."""
    assert dp.split_smem(dp.SPLIT, "packed6", 4, 8, 8, 2048) == 208384
    assert dp.split_smem(dp.SPLIT16, "bytes", 1, 8, 24, 1024) > dp.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        dp.plan(1024, "bytes", 1, dp16=True, strips=8, width=24, **DEFAULT)
    assert dp.plan(1024, "bytes", 1, dp16=True, strips=4, width=24,
                   **DEFAULT) == dp.Plan(dp.SPLIT16, 4, 24)


@pytest.mark.parametrize("sc", [(1, -1, -1, -1), (40, -30, -64, -20)])
def test_every_default_plan_fits_shared_memory(sc):
    """Every launch the gate makes by default, at every tile size up to
    MAX_TILE in every format and interleave, fits a block's shared memory
    (plan raises otherwise)."""
    kw = _scoring(sc)
    for T in range(1, dp.MAX_TILE + 1):
        for fmt in dp.SPLIT16_FORMATS:
            for il in (1,) if fmt == "plane2" else dp.INTERLEAVES:
                dp.plan(T, fmt, il, **kw)
