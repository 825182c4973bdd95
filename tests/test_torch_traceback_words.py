"""darwin_tpu_torch word walkers against the JAX package's.

traceback_packed_torch and traceback_packed6_torch (the plain versions
of csrc/traceback_words.cu) must equal traceback_packed_jax and
traceback_packed6_jax bit for bit on the words pack_dir_words /
pack_dir_words6 make of align_tiles_jax's dir bytes: ``raw & 3`` the
ops, ``raw >= MATCH_BIT`` the match bits, slot for slot (the packed6
stream's holes included), and the step counts.  The cases are those of
tests/test_traceback_packed.py.  Tolerance 0: every output is an
integer.
"""

import numpy as np
import pytest
import torch

from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu.ops.traceback import (pack_dir_words, pack_dir_words6,
                                      traceback_packed6_jax,
                                      traceback_packed_jax)
from darwin_tpu_torch.ops import traceback as tb
from darwin_tpu_torch.ops.common import MATCH_BIT
from darwin_tpu_torch.ops.dp import align_tiles
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_dp import make_batch
from tests.test_traceback_packed import _random_tiles

SC = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
JAX_WALKERS = {"packed": (pack_dir_words, traceback_packed_jax),
               "packed6": (pack_dir_words6, traceback_packed6_jax)}
PLAIN = {"packed": tb.traceback_packed_torch,
         "packed6": tb.traceback_packed6_torch}
CASES = [(40, 0.1, False, 24), (40, 0.5, True, 24), (64, 0.02, True, 40),
         (32, 0.9, False, 200), (40, 0.05, False, 24)]


def _tiles(T, div, ragged, seed, B=32):
    rng = np.random.default_rng(seed)
    refs, queries, rlen, qlen = _random_tiles(rng, B, T, div, ragged)
    firsts = np.zeros(B, bool)
    firsts[::2] = True
    return align_tiles_jax(refs, queries, rlen, qlen, **SC), rlen, qlen, firsts


def _walk_both(fmt, out, rlen, qlen, firsts, et, **kw):
    """(port's plain walker, JAX walker) on the same words, as numpy."""
    pack, jwalk = JAX_WALKERS[fmt]
    words = pack(out["dir"])
    want = [np.asarray(x) for x in jwalk(
        words, rlen, qlen, firsts, out["max_i"], out["max_j"],
        early_terminate=et, **kw)]
    args = [torch.from_numpy(np.array(x)) for x in
            (words, rlen, qlen, firsts, out["max_i"], out["max_j"])]
    got = [x.numpy() for x in PLAIN[fmt](*args, early_terminate=et, **kw)]
    return got, want


def _assert_same(got, want):
    raw, i_steps, j_steps = got
    ops, mbits, wi, wj = want
    assert raw.dtype == np.uint8 and raw.shape == ops.T.shape
    np.testing.assert_array_equal(raw & 3, ops.T, err_msg="ops")
    np.testing.assert_array_equal(raw >= MATCH_BIT, mbits.T, err_msg="mbits")
    np.testing.assert_array_equal(i_steps, wi, err_msg="i_steps")
    np.testing.assert_array_equal(j_steps, wj, err_msg="j_steps")


@pytest.mark.parametrize("fmt", ["packed", "packed6"])
@pytest.mark.parametrize("T,div,ragged,et", CASES)
def test_word_walkers_match_jax(fmt, T, div, ragged, et):
    out, rlen, qlen, firsts = _tiles(T, div, ragged, T * 7 + int(div * 100))
    got, want = _walk_both(fmt, out, rlen, qlen, firsts, et)
    _assert_same(got, want)
    assert (got[0] != 0).any()
    if fmt == "packed6" and div < 0.5:
        # The 4-slot groups leave holes inside the stream.
        nz = got[0] != 0
        assert (~nz[:, :-1] & nz[:, 1:]).any()


@pytest.mark.parametrize("fmt", ["packed", "packed6"])
@pytest.mark.parametrize("T", [24, 64])
def test_word_walkers_match_jax_on_walk_cases(fmt, T):
    """chip_smoke.walk_cases, the adversarial tiles the card runs the
    windowed word walkers on, packed by the port's packers: the plain
    word walkers equal the JAX's on the JAX's packing of the same bytes,
    at two early_terminates (gap runs past a window's 32 rows and 64
    columns at T = 64, walks across row 0 and column 0, cut-offs on
    either axis, empty walks, clipped starts)."""
    import chip_smoke
    from darwin_tpu_torch.ops.dp import PACKERS

    cases = chip_smoke.walk_cases(np.random.default_rng(T + 1), T)
    dirm, rest = cases[0], cases[1:]
    words = PACKERS[fmt](torch.from_numpy(dirm))
    pack, jwalk = JAX_WALKERS[fmt]
    np.testing.assert_array_equal(words.numpy(), np.asarray(pack(dirm)))
    for et in (T * 5 // 8, T):
        got = [x.numpy() for x in PLAIN[fmt](
            words, *(torch.from_numpy(x) for x in rest), early_terminate=et)]
        want = [np.asarray(x) for x in jwalk(np.asarray(pack(dirm)), *rest,
                                              early_terminate=et)]
        _assert_same(got, want)
        wi, wj = want[2], want[3]
        assert ((wi == et) & (wj < et)).any()
        assert ((wj == et) & (wi < et)).any()
        assert not got[0][11:13].any() and not got[0][15].any()


@pytest.mark.parametrize("fmt", ["packed", "packed6"])
def test_word_walkers_degenerate_first_tiles(fmt):
    """All-mismatch first tiles start at (0, 0) and walk nothing."""
    B, T = 8, 24
    refs = np.full((B, T), ord("A"), np.uint8)
    queries = np.full((B, T), ord("C"), np.uint8)
    lens = np.full(B, T, np.int32)
    out = align_tiles_jax(refs, queries, lens, lens, **SC)
    got, want = _walk_both(fmt, out, lens, lens, np.ones(B, bool), 16)
    _assert_same(got, want)
    assert not got[0].any() and not got[1].any()


@pytest.mark.parametrize("unroll", [1, 2, 4])
@pytest.mark.parametrize("T,div,ragged,et", [(40, 0.1, False, 24),
                                             (64, 0.02, True, 40)])
def test_packed_unroll_matches_jax(T, div, ragged, et, unroll):
    out, rlen, qlen, firsts = _tiles(T, div, ragged, T + unroll)
    got, want = _walk_both("packed", out, rlen, qlen, firsts, et,
                           unroll=unroll)
    _assert_same(got, want)


@pytest.mark.parametrize("kb", [0, 1, 4, 8, 16, 31])
def test_packed6_compact_matches_jax(kb):
    """Lane compaction: the width grows by one spare group, and the slots
    are the JAX's, for compact_b from off to nearly B (= 32)."""
    T, div, ragged, et = (48, 0.3, True, 30) if kb % 2 else \
        (40, 0.05, False, 24)
    out, rlen, qlen, firsts = _tiles(T, div, ragged, T * 13 + kb)
    got, want = _walk_both("packed6", out, rlen, qlen, firsts, et,
                           compact_b=kb)
    _assert_same(got, want)
    assert got[0].shape[1] == 4 * et + (4 if kb else 0)


@pytest.mark.parametrize("fmt", ["packed", "packed6"])
@pytest.mark.parametrize("sc", [(1, -1, -1, -1), (2, -3, -4, -2)])
def test_port_dp_words_with_short_tiles(fmt, sc):
    """The port's own align_tiles words (rlen < T tiles, the rows past
    rlen carrying bytes in their upper fields) walk as the JAX walker
    walks the JAX's words."""
    rng = np.random.default_rng(17)
    B, T, et = 24, 48, 32
    ref, query, rlen, qlen = make_batch(rng, B, T)
    assert (rlen < T).any()
    first = rng.random(B) < 0.5
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
    port = align_tiles(*(torch.from_numpy(x) for x in (ref, query, rlen,
                                                       qlen)),
                       dir_format=fmt, **kw)
    walk = getattr(tb, "traceback_" + fmt)
    got = [x.numpy() for x in walk(
        port["dir_words"], torch.from_numpy(rlen), torch.from_numpy(qlen),
        torch.from_numpy(first), port["max_i"], port["max_j"],
        early_terminate=et)]
    out = align_tiles_jax(ref, query, rlen, qlen, **kw)
    pack, jwalk = JAX_WALKERS[fmt]
    want = [np.asarray(x) for x in jwalk(
        pack(out["dir"]), rlen, qlen, first, out["max_i"], out["max_j"],
        early_terminate=et)]
    _assert_same(got, want)


def test_word_walker_dispatch():
    out, rlen, qlen, firsts = _tiles(24, 0.1, True, 3, B=4)
    for fmt, walk in (("packed", tb.traceback_packed),
                      ("packed6", tb.traceback_packed6)):
        words = torch.from_numpy(np.array(JAX_WALKERS[fmt][0](out["dir"])))
        args = [words] + [torch.from_numpy(np.array(x)) for x in
                          (rlen, qlen, firsts, out["max_i"], out["max_j"])]
        n = walk.launches
        got = walk(*args, early_terminate=8)
        want = PLAIN[fmt](*args, early_terminate=8)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert walk.launches == n  # the CPU runs the plain version
        with pytest.raises(ValueError):
            walk(*(a.to("meta") for a in args), early_terminate=8)
    with pytest.raises(ValueError):
        tb.traceback_packed_torch(*args, early_terminate=8, unroll=0)
