"""darwin_tpu_torch traceback walker against the JAX package's walkers.

traceback_torch (the CUDA walker's plain version) returns the op stream
dense as op | MATCH_BIT; it must equal traceback_jax's ops, mbits and
step counts bit for bit, and the packed6 walker the JAX engine runs on
its nonzero op subsequence (that walker leaves holes).  First tiles
(start at the max cell) and corner-anchored tiles are mixed in every
batch.
"""

import numpy as np
import pytest
import torch

from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu.ops.traceback import (pack_dir_words6, traceback_jax,
                                      traceback_packed6_jax)
from darwin_tpu_torch.ops import traceback as tb
from darwin_tpu_torch.ops.common import MATCH_BIT
from darwin_tpu_torch.ops.traceback import traceback_torch
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_dp import GE, GO, MATCH, MISMATCH, make_batch

CASES = [(24, 32, 12, 0), (24, 64, 24, 1), (32, 64, 40, 2), (16, 48, 48, 3)]


def _batch(B, T, seed, sc=(MATCH, MISMATCH, GO, GE)):
    rng = np.random.default_rng(seed)
    alpha = b"ACGT" if seed % 2 == 0 else b"ACN"
    ref, query, rlen, qlen = make_batch(rng, B, T, alpha=alpha)
    first = rng.random(B) < 0.5
    first[:2] = [True, False]
    out = align_tiles_jax(ref, query, rlen, qlen, match=sc[0],
                          mismatch=sc[1], gap_open=sc[2], gap_extend=sc[3])
    return out, rlen, qlen, first


def _tensors(out, rlen, qlen, first):
    return [torch.from_numpy(np.array(x)) for x in
            (out["dir"], rlen, qlen, first, out["max_i"], out["max_j"])]


def _walk_torch(out, rlen, qlen, first, et):
    raw, i_steps, j_steps = traceback_torch(
        *_tensors(out, rlen, qlen, first), early_terminate=et)
    return raw.numpy(), i_steps.numpy(), j_steps.numpy()


@pytest.mark.parametrize("B,T,et,seed", CASES)
def test_traceback_torch_matches_jax(B, T, et, seed):
    out, rlen, qlen, first = _batch(B, T, seed)
    raw, i_steps, j_steps = _walk_torch(out, rlen, qlen, first, et)
    ops, mbits, wi, wj = traceback_jax(out["dir"], rlen, qlen, first,
                                       out["max_i"], out["max_j"],
                                       early_terminate=et)
    assert raw.shape == (B, 2 * et - 1) and raw.dtype == np.uint8
    np.testing.assert_array_equal(raw & 3, np.asarray(ops).T)
    np.testing.assert_array_equal(raw >= MATCH_BIT, np.asarray(mbits).T)
    np.testing.assert_array_equal(i_steps, np.asarray(wi))
    np.testing.assert_array_equal(j_steps, np.asarray(wj))
    assert (raw != 0).any() and first.any() and not first.all()


@pytest.mark.parametrize("sc", [(MATCH, MISMATCH, GO, GE), (2, -3, -4, -2)])
@pytest.mark.parametrize("B,T,et,seed", CASES[1:3])
def test_traceback_torch_matches_packed6_walker(B, T, et, seed, sc):
    out, rlen, qlen, first = _batch(B, T, seed, sc)
    raw, i_steps, j_steps = _walk_torch(out, rlen, qlen, first, et)
    ops6, mbits6, wi, wj = traceback_packed6_jax(
        pack_dir_words6(out["dir"]), rlen, qlen, first, out["max_i"],
        out["max_j"], early_terminate=et)
    ops6, mbits6 = np.asarray(ops6).T, np.asarray(mbits6).T
    np.testing.assert_array_equal(i_steps, np.asarray(wi))
    np.testing.assert_array_equal(j_steps, np.asarray(wj))
    for b in range(B):
        dense = raw[b][raw[b] != 0]
        holes = ops6[b] != 0
        np.testing.assert_array_equal(dense & 3, ops6[b][holes], err_msg=b)
        np.testing.assert_array_equal(dense >= MATCH_BIT, mbits6[b][holes],
                                      err_msg=b)


def test_traceback_dispatch():
    out, rlen, qlen, first = _batch(4, 16, 4)
    args = _tensors(out, rlen, qlen, first)
    got = tb.traceback(*args, early_terminate=8)
    want = traceback_torch(*args, early_terminate=8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        tb.traceback(*(a.to("meta") for a in args), early_terminate=8)


def _longest_run(ops: np.ndarray, op: int) -> int:
    """Longest run of op in any lane of an [B, S] op stream."""
    best = 0
    for row in ops:
        run = 0
        for v in row:
            run = run + 1 if v == op else 0
            best = max(best, run)
    return best


@pytest.mark.parametrize("T", [24, 64])
def test_traceback_torch_matches_jax_on_walk_cases(T):
    """chip_smoke.walk_cases, the adversarial tiles the card test runs
    the windowed walker on, at two early_terminates: traceback_torch
    equals traceback_jax, and the cases do what they claim (gap runs
    past the window's 32 rows at T = 64, cut-offs on either axis, empty
    walks)."""
    import chip_smoke

    cases = chip_smoke.walk_cases(np.random.default_rng(T), T)
    for et in (T * 5 // 8, T):
        raw, i_steps, j_steps = traceback_torch(
            *(torch.from_numpy(x) for x in cases), early_terminate=et)
        raw = raw.numpy()
        ops, mbits, wi, wj = traceback_jax(*cases, early_terminate=et)
        np.testing.assert_array_equal(raw & 3, np.asarray(ops).T)
        np.testing.assert_array_equal(raw >= MATCH_BIT, np.asarray(mbits).T)
        np.testing.assert_array_equal(i_steps.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(j_steps.numpy(), np.asarray(wj))
        assert _longest_run(raw & 3, 2) == et
        assert _longest_run(raw & 3, 1) == et
        wi, wj = np.asarray(wi), np.asarray(wj)
        assert ((wi == et) & (wj < et)).any()
        assert ((wj == et) & (wi < et)).any()
        assert not raw[11:13].any() and not raw[15].any()
    if T == 64:
        lane0 = raw[0] & 3
        assert _longest_run(lane0[None], 2) > 32
