"""darwin_tpu_torch tile DP against the JAX package's, bit-exact.

align_tiles_torch (the CUDA kernel's plain version) is held against
align_tiles_jax, the JAX package's own oracle for its Pallas kernel,
and once against that Pallas kernel in interpret mode.  The CUDA
kernel is compared with align_tiles_torch on the card in
tests/test_torch_cuda.py.  All outputs are integers: the tolerance
is 0.
"""

import numpy as np
import pytest
import torch

from darwin_tpu.ops.pallas_dp import align_tiles_pallas
from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu_torch.ops import dp
from darwin_tpu_torch.ops.reference_dp import align_tiles_torch
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_dp import GE, GO, MATCH, MISMATCH, make_batch

KEYS = ("dir", "max_score", "max_i", "max_j", "pos_score")


def _scoring(sc):
    return dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))


def _torch_out(ref, query, rlen, qlen, **kw):
    out = align_tiles_torch(torch.from_numpy(ref), torch.from_numpy(query),
                            torch.from_numpy(rlen), torch.from_numpy(qlen),
                            **kw)
    return {k: v.numpy() for k, v in out.items()}


def _assert_same(got, want, cols=None):
    for k in KEYS:
        w = np.asarray(want[k])
        if k == "dir" and cols is not None:
            w = w[:, :, :cols]
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _related(rng, B, T):
    """Mutated copies (15% substitutions), lengths in [T/2, T], as
    test_pallas_dp's non-default-scoring case builds them."""
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = alpha[rng.integers(0, 4, size=(B, T))]
    query = ref.copy()
    mut = rng.random((B, T)) < 0.15
    query[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
    rlen = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    qlen = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    return ref, query, rlen, qlen


@pytest.mark.parametrize("B,T,seed", [(8, 24, 0), (16, 40, 1), (8, 24, 2),
                                      (32, 64, 3)])
def test_align_tiles_torch_matches_jax(B, T, seed):
    rng = np.random.default_rng(seed)
    ref, query, rlen, qlen = make_batch(rng, B, T)
    kw = _scoring((MATCH, MISMATCH, GO, GE))
    _assert_same(_torch_out(ref, query, rlen, qlen, **kw),
                 align_tiles_jax(ref, query, rlen, qlen, **kw))


# The JAX suite's three non-default sets, then a positive mismatch and
# a positive gap_open: the cases where the Pallas kernel needs its
# explicit lane-0 masks (pallas_dp.py:150-163).
@pytest.mark.parametrize("sc", [(2, -3, -4, -2), (5, -4, -8, -6),
                                (3, -1, -2, -1), (2, 1, -3, -1),
                                (2, -1, 1, -2)])
def test_align_tiles_torch_scoring_sets(sc):
    rng = np.random.default_rng(sum(abs(x) for x in sc))
    ref, query, rlen, qlen = _related(rng, 16, 64)
    kw = _scoring(sc)
    _assert_same(_torch_out(ref, query, rlen, qlen, **kw),
                 align_tiles_jax(ref, query, rlen, qlen, **kw))


def test_align_tiles_torch_edge_tiles():
    """Idle slots, empty ref or query, and all-zero tiles.  The max
    cell is the row-major-last cell at >= from 0, so an all-zero tile
    with qlen >= 1 reports (rlen, qlen), not (0, 0)."""
    B, T = 8, 32
    ref = np.full((B, T), ord("A"), dtype=np.uint8)
    query = np.full((B, T), ord("C"), dtype=np.uint8)
    rlen = np.array([0, 0, 5, 7, 32, 1, 32, 3], dtype=np.int32)
    qlen = np.array([0, 4, 0, 9, 32, 1, 1, 32], dtype=np.int32)
    kw = _scoring((MATCH, MISMATCH, GO, GE))
    got = _torch_out(ref, query, rlen, qlen, **kw)
    _assert_same(got, align_tiles_jax(ref, query, rlen, qlen, **kw))
    zero = (rlen > 0) & (qlen > 0)
    np.testing.assert_array_equal(got["max_score"], 0)
    np.testing.assert_array_equal(got["max_i"], np.where(zero, rlen, 0))
    np.testing.assert_array_equal(got["max_j"], np.where(zero, qlen, 0))


def test_align_tiles_torch_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    B, T = 16, 40
    ref, query, rlen, qlen = make_batch(rng, B, T)
    kw = _scoring((MATCH, MISMATCH, GO, GE))
    want = align_tiles_pallas(ref, query, rlen, qlen, block_b=8,
                              interpret=True, **kw)
    _assert_same(_torch_out(ref, query, rlen, qlen, **kw), want,
                 cols=T + 1)


def test_align_tiles_dispatch():
    """CPU tensors take the plain version; a tensor on a device with no
    kernel raises instead of falling back."""
    rng = np.random.default_rng(6)
    ref, query, rlen, qlen = (torch.from_numpy(x)
                              for x in make_batch(rng, 4, 16))
    kw = _scoring((MATCH, MISMATCH, GO, GE))
    got = dp.align_tiles(ref, query, rlen, qlen, **kw)
    want = align_tiles_torch(ref, query, rlen, qlen, **kw)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError):
        dp.align_tiles(*(x.to("meta") for x in (ref, query, rlen, qlen)),
                       **kw)
