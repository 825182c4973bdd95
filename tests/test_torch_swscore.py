"""darwin_tpu_torch score-only SW against the JAX package's.

local_score_batch_torch (the plain version of csrc/swscore.cu) must
equal darwin_tpu.ops.swscore.local_score_batch on ragged rectangular
pairs under three scoring sets, and the port's score evaluator
(darwin_tpu_torch.eval.score_eval) the JAX one on the case of
tests/test_score_eval.py.  Tolerance 0: scores are integers.
"""

import numpy as np
import pytest
import torch

from darwin_tpu.eval import score_eval as jax_eval
from darwin_tpu.ops.swscore import local_score_batch as jax_local_score
from darwin_tpu_torch.eval import score_eval
from darwin_tpu_torch.eval.datagen import synth_genome, two_readsets
from darwin_tpu_torch.ops import swscore
from tests._torch_threads import one_torch_thread  # noqa: F401

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _pairs(seed, B, LR, LQ):
    """Related ragged pairs (query a mutated window of ref, or random),
    zero-padded; lanes 0 and 1 have an empty ref and an empty query."""
    rng = np.random.default_rng(seed)
    ref = np.zeros((B, LR), np.uint8)
    query = np.zeros((B, LQ), np.uint8)
    rlen = rng.integers(1, LR + 1, size=B).astype(np.int32)
    qlen = rng.integers(1, LQ + 1, size=B).astype(np.int32)
    rlen[0] = qlen[1] = 0
    for b in range(B):
        r = ACGT[rng.integers(0, 4, size=rlen[b])]
        if b % 3 == 2:
            q = ACGT[rng.integers(0, 4, size=qlen[b])]
        else:
            off = int(rng.integers(0, max(1, rlen[b] // 2)))
            q = np.concatenate([r[off:], ACGT[rng.integers(0, 4, size=LQ)]])
            q = q[:qlen[b]].copy()
            mut = rng.random(len(q)) < 0.1
            q[mut] = ACGT[rng.integers(0, 4, size=int(mut.sum()))]
            q = np.delete(q, np.flatnonzero(rng.random(len(q)) < 0.05))
            qlen[b] = len(q)
        ref[b, :rlen[b]] = r
        query[b, :qlen[b]] = q
    return ref, query, rlen, qlen


@pytest.mark.parametrize("sc", [(1, -1, -1, -1), (2, -3, -4, -2),
                                (3, -1, -2, -1)])
@pytest.mark.parametrize("B,LR,LQ,seed", [(12, 300, 220, 0),
                                          (9, 90, 310, 1)])
def test_local_score_matches_jax(sc, B, LR, LQ, seed):
    ref, query, rlen, qlen = _pairs(seed, B, LR, LQ)
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
    want = np.asarray(jax_local_score(ref, query, rlen, qlen, **kw))
    got = swscore.local_score_batch_torch(
        *(torch.from_numpy(x) for x in (ref, query, rlen, qlen)), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() >= B - 2


@pytest.mark.parametrize("sc", [(1, -1, -1, -1), (2, -3, -4, -2)])
def test_local_score_matches_jax_at_kernel_edge_shapes(sc):
    """chip_smoke.sw_edge_shapes, where the card kernel's passes, column
    strips and warps end (a query one below, at and one above a pass,
    several passes, refs shorter than the warps, one row, one column),
    with empty and full-length lanes, at B = 4."""
    import chip_smoke

    rng = np.random.default_rng(sum(sc) + 20)
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
    for LR, LQ in chip_smoke.sw_edge_shapes():
        ref, query, rlen, qlen = chip_smoke.sw_edge_pairs(rng, 4, LR, LQ)
        want = np.asarray(jax_local_score(ref, query, rlen, qlen, **kw))
        got = swscore.local_score_batch_torch(
            *(torch.from_numpy(x) for x in (ref, query, rlen, qlen)), **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str((LR,
                                                                     LQ)))
        assert want[0] == want[1] == 0 and want[2] > 0


def test_local_score_dispatch():
    ref, query, rlen, qlen = (torch.from_numpy(x) for x in
                              _pairs(2, 4, 40, 30))
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    n = swscore.local_score_batch.launches
    assert torch.equal(swscore.local_score_batch(ref, query, rlen, qlen, **kw),
                       swscore.local_score_batch_torch(ref, query, rlen, qlen,
                                                       **kw))
    assert swscore.local_score_batch.launches == n
    with pytest.raises(ValueError):
        swscore.local_score_batch(*(x.to("meta") for x in
                                    (ref, query, rlen, qlen)), **kw)


def test_evaluate_scores_matches_jax():
    """The case of tests/test_score_eval.py::
    test_evaluate_scores_end_to_end: two read sets from one genome,
    overlapped by the port's host engine; both evaluators score the same
    records against their exact pair scores."""
    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.io.fasta import FastaRecord
    from darwin_tpu_torch.pipeline import run_pipeline

    rng = np.random.default_rng(17)
    genome = synth_genome(9000, rng)
    a, b = two_readsets(genome, 5, 2500, rng, error_rate=0.05,
                        rc_fraction=0.5)
    params = Params(seed_size=12, tile_size=64, tile_overlap=24,
                    threshold=12, bin_size=32, window_size=4)
    res = run_pipeline([FastaRecord([n], s) for n, s in a],
                       [FastaRecord([n], s) for n, s in b], params,
                       same_file=False, batch_size=64, engine="host",
                       device="cpu")
    records = sorted(set(res.records))
    args = (records, [n for n, _ in a], [n for n, _ in b],
            [s for _, s in a], [s for _, s in b])
    got = score_eval.evaluate_scores(*args, min_overlap=1000, device="cpu")
    assert vars(got) == vars(jax_eval.evaluate_scores(*args,
                                                      min_overlap=1000))
    assert got.n_matched > 0 and got.higher_score == 0
