"""darwin_tpu_torch GACT engine against the JAX package's device engine.

* _score_ops (incremental rescoring) against the JAX engine's, fed the
  JAX packed6 walker's op streams, holes included;
* the port's DeviceGactEngine on the CPU against the JAX
  DeviceGactEngine(backend="lax") on the tiny fixture's D-SOFT calls,
  record for record and in the same order, in the byte format and in
  both word formats (tb_format "packed", "packed6") against the JAX
  engine in the same format;
* run_pipeline on tiny against the reference binary's out.darwin;
* a tile size past the CUDA DP kernel's limit fails when the engine or
  the host engine's aligner is built on a CUDA device, before any seed
  work, through the constructors, run_pipeline and the CLI; the CPU
  takes it.
"""

import numpy as np
import pytest
import torch

from darwin_tpu.engine import device_batch as jdb
from darwin_tpu.engine.seqbank import SeqBank as JaxSeqBank
from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu.ops.traceback import pack_dir_words6, traceback_packed6_jax
from darwin_tpu_torch.coding import seq_to_bytes
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.engine.batch import GactCalls
from darwin_tpu_torch.engine.device_batch import DeviceGactEngine, _score_ops
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import parse_fasta, revcomp
from darwin_tpu_torch import cli, pipeline
from darwin_tpu_torch.engine.aligner import TorchTileAligner
from darwin_tpu_torch.pipeline import collect_calls, run_pipeline
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_dp import make_batch


@pytest.mark.parametrize("sc", [(1, -1, -1, -1), (2, -3, -4, -2)])
def test_score_ops_matches_jax_on_packed6_ops(sc):
    rng = np.random.default_rng(11)
    B, T, et = 32, 64, 40
    ref, query, rlen, qlen = make_batch(rng, B, T)
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
    out = align_tiles_jax(ref, query, rlen, qlen, **kw)
    first = rng.random(B) < 0.5
    ops, mbits, _, _ = traceback_packed6_jax(
        pack_dir_words6(out["dir"]), rlen, qlen, first, out["max_i"],
        out["max_j"], early_terminate=et)
    opsT, mbitsT = np.array(ops).T, np.array(mbits).T
    opsT[3] = 0  # a lane with no ops keeps its prev_gap
    assert ((opsT[:, :-1] == 0) & (opsT[:, 1:] != 0)).any()  # holes
    prev_gap = rng.random(B) < 0.5
    st = jdb._Static(B=B, T=T, ET=et, Ncap=0, threshold=0, same_file=True,
                     compute_score=True, backend="lax", block_b=B, **kw)
    want = jdb._score_ops(st, opsT, mbitsT, prev_gap)
    got = _score_ops(torch.from_numpy(opsT), torch.from_numpy(mbitsT),
                     torch.from_numpy(prev_gap), **kw)
    for name, g, w in zip(("delta", "prev_gap", "first_gap", "has_ops",
                           "n_match"), got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32)


@pytest.fixture(scope="module")
def tiny_calls(data_dir):
    d = data_dir / "tiny"
    params = Params.from_cfg(d / "params.cfg")
    reads = parse_fasta(d / "reads.fasta")
    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    fwd = [seq_to_bytes(r.seq) for r in reads]
    rev = [seq_to_bytes(revcomp(r.seq)) for r in reads]
    merged = SeqBank(fwd + rev)
    calls_m = collect_calls(table, genome, merged, params)
    R = len(reads)
    comp = (calls_m.query_id >= R).astype(np.int32)
    calls = GactCalls(calls_m.ref_id, calls_m.query_id % R,
                      calls_m.ref_pos, calls_m.query_pos)
    return params, genome, fwd + rev, calls, comp, calls_m.query_id


@pytest.mark.parametrize("compute_score", [True, False])
def test_engine_matches_jax_device_engine(tiny_calls, compute_score):
    params, genome, seqs, calls, comp, bank_ids = tiny_calls
    kw = dict(tile_size=params.tile_size,
              early_terminate=params.early_terminate,
              first_tile_score_threshold=params.first_tile_score_threshold,
              match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_extend=params.gap_extend,
              same_file=True, batch_size=16, compute_score=compute_score)
    assert len(calls) > kw["batch_size"]  # slots are refilled
    jax_eng = jdb.DeviceGactEngine(genome, JaxSeqBank(seqs), backend="lax",
                                   **kw)
    want = jax_eng.finish(jax_eng.run_async(calls, comp, bank_ids))
    eng = DeviceGactEngine(genome, SeqBank(seqs), device="cpu", **kw)
    got = eng.finish(eng.run_async(calls, comp, bank_ids))
    assert len(got) > 0
    assert [tuple(vars(r).values()) for r in got] == \
        [tuple(vars(r).values()) for r in want]
    assert (eng.last_iters, eng.last_active_sum) == (
        jax_eng.last_iters, jax_eng.last_active_sum)


@pytest.mark.parametrize("tb_format", ["packed", "packed6"])
def test_engine_word_formats_match_jax_device_engine(tiny_calls, tb_format):
    params, genome, seqs, calls, comp, bank_ids = tiny_calls
    kw = dict(tile_size=params.tile_size,
              early_terminate=params.early_terminate,
              first_tile_score_threshold=params.first_tile_score_threshold,
              match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_extend=params.gap_extend,
              same_file=True, batch_size=16, tb_format=tb_format)
    jax_eng = jdb.DeviceGactEngine(genome, JaxSeqBank(seqs), backend="lax",
                                   **kw)
    want = jax_eng.finish(jax_eng.run_async(calls, comp, bank_ids))
    eng = DeviceGactEngine(genome, SeqBank(seqs), device="cpu", **kw)
    got = eng.finish(eng.run_async(calls, comp, bank_ids))
    assert len(got) > 0
    assert [tuple(vars(r).values()) for r in got] == \
        [tuple(vars(r).values()) for r in want]
    assert (eng.last_iters, eng.last_active_sum) == (
        jax_eng.last_iters, jax_eng.last_active_sum)


def test_run_pipeline_tiny_matches_reference(data_dir):
    d = data_dir / "tiny"
    params = Params.from_cfg(d / "params.cfg")
    reads = parse_fasta(d / "reads.fasta")
    metrics = {}
    res = run_pipeline(reads, reads, params, True, batch_size=32,
                       device="cpu", metrics=metrics)
    assert set(res.records) == set((d / "out.darwin").read_text()
                                   .splitlines())
    assert res.num_candidates_for + res.num_candidates_rev > 0
    assert metrics["engine_iters"] > 0 and metrics["align_s"] > 0
    assert metrics["drain_redispatches"] == 0  # tiny: N <= B
    # darwin_tpu.pipeline.run_pipeline's keys.
    assert {"genome_banks_s", "engine_build_s", "table_s", "seed_s",
            "align_s", "format_s"} <= metrics.keys()


def test_engine_rejects_pieces_past_int32(tiny_calls):
    """Positions inside a piece are int32 on the device."""
    params, genome, seqs, *_ = tiny_calls
    big = Genome([], params.bin_size)
    big.piece_lengths = np.array([2 ** 31], dtype=np.int64)
    kw = dict(tile_size=64, early_terminate=40,
              first_tile_score_threshold=35, match=1, mismatch=-1,
              gap_open=-1, gap_extend=-1, same_file=True, device="cpu")
    with pytest.raises(ValueError, match="reference piece"):
        DeviceGactEngine(big, SeqBank(seqs), **kw)
    with pytest.raises(ValueError, match="tb_format"):
        DeviceGactEngine(genome, SeqBank(seqs), tb_format="words", **kw)
    eng = DeviceGactEngine(genome, SeqBank(seqs), **kw)
    assert [eng.slots(n) for n in (1, 90, 100, 300)] == [64, 96, 128, 256]


@pytest.mark.parametrize("engine", ["device", "host"])
def test_tile_size_past_the_kernel_fails_before_seed_work(
        data_dir, tmp_path, monkeypatch, engine):
    """tile_size 2049 in params.cfg, past the reference's limit: on
    "cuda" the engine (or aligner) raises naming the limit, 2048, before
    the seed table or D-SOFT run (no card is touched: the check comes
    first); on the CPU it is built."""
    d = data_dir / "tiny"
    cfg = tmp_path / "params.cfg"
    cfg.write_text((d / "params.cfg").read_text()
                   .replace("tile_size = 64", "tile_size = 2049"))
    params = Params.from_cfg(cfg)
    assert params.tile_size == 2049
    reads = parse_fasta(d / "reads.fasta")

    def no_seed_work(*a, **k):
        raise AssertionError("seed work before the engine check")

    monkeypatch.setattr(SeedTable, "build", no_seed_work)
    monkeypatch.setattr(pipeline, "collect_calls", no_seed_work)
    with pytest.raises(ValueError, match="2048"):
        run_pipeline(reads, reads, params, True, engine=engine,
                     device="cuda")
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="2048"):
        cli.main([str(d / "reads.fasta"), str(d / "reads.fasta"),
                  "--params", str(cfg), "--engine", engine, "--out-dir",
                  str(tmp_path / "out")])
    kw = dict(early_terminate=params.early_terminate, match=1, mismatch=-1,
              gap_open=-1, gap_extend=-1, tile_size=2049)
    with pytest.raises(ValueError, match="TorchTileAligner.*2048"):
        TorchTileAligner(device="cuda", **kw)
    TorchTileAligner(device="cpu", **kw)
    genome = Genome(reads, params.bin_size)
    bank = SeqBank([seq_to_bytes(r.seq) for r in reads])
    ekw = dict(tile_size=2049, early_terminate=params.early_terminate,
               first_tile_score_threshold=0, match=1, mismatch=-1,
               gap_open=-1, gap_extend=-1, same_file=True)
    with pytest.raises(ValueError, match="DeviceGactEngine.*2048"):
        DeviceGactEngine(genome, bank, device="cuda", **ekw)
    DeviceGactEngine(genome, bank, device="cpu", **ekw)
