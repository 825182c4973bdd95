"""darwin_tpu_torch host-stepped engine against the JAX package's.

* score_ops_batch (char-gather rescoring) against the JAX's on packed6
  op streams, holes included;
* TorchTileAligner on the CPU against JaxTileAligner(backend="lax") on
  the same tiles: every TileResult field equal;
* run_gact_batch against the JAX's on the tiny fixture's D-SOFT calls,
  both strands (the reads and their reverse complements against the
  fixture), with and without rescoring: the same records in the same
  order;
* run_pipeline(engine="host") on tiny against the reference binary's
  out.darwin.
"""

import numpy as np
import pytest

from darwin_tpu.engine import scoring as jax_scoring
from darwin_tpu.engine.aligner import JaxTileAligner
from darwin_tpu.engine.batch import GactCalls as JaxCalls
from darwin_tpu.engine.batch import run_gact_batch as jax_run_gact_batch
from darwin_tpu.engine.seqbank import SeqBank as JaxSeqBank
from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu.ops.traceback import pack_dir_words6, traceback_packed6_jax
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.engine import scoring
from darwin_tpu_torch.engine.aligner import TorchTileAligner
from darwin_tpu_torch.engine.batch import run_gact_batch
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import FastaRecord, parse_fasta, revcomp
from darwin_tpu_torch.pipeline import (collect_calls, make_aligner,
                                       read_banks, run_pipeline)
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_dp import make_batch


@pytest.mark.parametrize("sc", [(1, -1, -1, -1), (2, -3, -4, -2)])
def test_score_ops_batch_matches_jax_on_packed6_ops(sc):
    rng = np.random.default_rng(23)
    B, T, et = 32, 64, 40
    ref, query, rlen, qlen = make_batch(rng, B, T)
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
    out = align_tiles_jax(ref, query, rlen, qlen, **kw)
    ops, _, _, _ = traceback_packed6_jax(
        pack_dir_words6(out["dir"]), rlen, qlen, rng.random(B) < 0.5,
        out["max_i"], out["max_j"], early_terminate=et)
    ops = np.array(ops).T
    ops[5] = 0
    assert ((ops[:, :-1] == 0) & (ops[:, 1:] != 0)).any()  # holes
    seqs = rng.integers(65, 69, size=(B, 400)).astype(np.uint8)
    seqs_q = seqs.copy()
    seqs_q[rng.random(seqs.shape) < 0.2] = 65
    pos_r = rng.integers(0, 400, size=B)
    pos_q = rng.integers(0, 400, size=B)
    rev = rng.random(B) < 0.5
    prev_gap = rng.random(B) < 0.5
    rows = np.arange(B)[:, None]

    def chars(s):
        return lambda idx: s[rows, np.clip(idx, 0, s.shape[1] - 1)]

    args = (ops, chars(seqs), chars(seqs_q), pos_r, pos_q, rev, prev_gap)
    got = scoring.score_ops_batch(*args, scoring.ScoreParams(*sc))
    want = jax_scoring.score_ops_batch(*args, jax_scoring.ScoreParams(*sc))
    for name, g, w in zip(("delta", "prev_gap", "first_gap", "n_match"),
                          got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("B,T,et,seed", [(24, 64, 40, 0), (16, 48, 24, 1)])
def test_torch_tile_aligner_matches_jax(B, T, et, seed):
    rng = np.random.default_rng(seed)
    ref, query, rlen, qlen = make_batch(rng, B, T)
    rlen[0] = qlen[1] = 0
    first = rng.random(B) < 0.5
    kw = dict(early_terminate=et, match=2, mismatch=-3, gap_open=-4,
              gap_extend=-2)
    want = JaxTileAligner(tile_size=T, backend="lax", **kw)(
        ref, query, rlen, qlen, first)
    aligner = TorchTileAligner(device="cpu", **kw)
    got = aligner(ref, query, rlen.astype(np.int64), qlen.astype(np.int64),
                  first)
    for name in ("ops", "ref_steps", "query_steps", "score", "max_i",
                 "max_j"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype, name
    assert aligner.calls == 1


@pytest.fixture(scope="module")
def tiny(data_dir):
    d = data_dir / "tiny"
    params = Params.from_cfg(d / "params.cfg")
    reads = parse_fasta(d / "reads.fasta")
    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    return d, params, reads, genome, table


@pytest.mark.parametrize("compute_score", [True, False])
def test_run_gact_batch_matches_jax(tiny, compute_score):
    _, params, reads, genome, table = tiny
    sp = scoring.ScoreParams(params.match, params.mismatch, params.gap_open,
                             params.gap_extend)
    kw = dict(tile_size=params.tile_size,
              first_tile_score_threshold=params.first_tile_score_threshold,
              same_file=False, batch_size=8, compute_score=compute_score)
    jax_aligner = JaxTileAligner(
        tile_size=params.tile_size, early_terminate=params.early_terminate,
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_extend=params.gap_extend,
        backend="lax")
    aligner = make_aligner(params, "cpu")
    # Tiny's reads have no reverse-strand hits; their reverse complements
    # do.
    both = reads + [FastaRecord([r.name + "rc"], revcomp(r.seq))
                    for r in reads]
    n_recs, n_calls = [], []
    for comp, bank in zip((False, True), read_banks(both)):
        calls = collect_calls(table, genome, bank, params)
        n_calls.append(len(calls))
        got = run_gact_batch(genome, bank, calls, sp=sp, complement=comp,
                             aligner=aligner, **kw)
        jcalls = JaxCalls(calls.ref_id, calls.query_id, calls.ref_pos,
                          calls.query_pos)
        jbank = JaxSeqBank([bank.slice(k, 0, int(n))
                            for k, n in enumerate(bank.lengths)])
        want = jax_run_gact_batch(
            genome, jbank, jcalls,
            sp=jax_scoring.ScoreParams(*vars(sp).values()),
            complement=comp, aligner=jax_aligner, **kw)
        assert [tuple(vars(r).values()) for r in got] == \
            [tuple(vars(r).values()) for r in want]
        n_recs.append(len(got))
    assert min(n_recs) > 0 and min(n_calls) > kw["batch_size"]  # refills


def test_run_pipeline_host_engine_tiny_matches_reference(tiny):
    d, params, reads, *_ = tiny
    metrics = {}
    res = run_pipeline(reads, reads, params, True, batch_size=32,
                       engine="host", device="cpu", metrics=metrics)
    assert set(res.records) == set((d / "out.darwin").read_text()
                                   .splitlines())
    assert res.num_candidates_for + res.num_candidates_rev > 0
    assert metrics["engine_iters"] > 0 and metrics["align_s"] > 0
    with pytest.raises(ValueError, match="engine"):
        run_pipeline(reads, reads, params, True, engine="hybrid",
                     device="cpu")
