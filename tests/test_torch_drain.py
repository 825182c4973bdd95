"""darwin_tpu_torch's two-tier drain against darwin_tpu's.

The workload is tests/test_device_engine.py::
test_two_tier_drain_matches_host_engine's (8 kb genome, 64 reads, every
16th 2000 bases, N = 600 calls, 256 slots, T = 16, threshold 4,
default_rng(9)), where darwin_tpu's auto gate engages:

* the port's DeviceGactEngine on the CPU, drain and gate on (darwin_tpu's
  auto), gives darwin_tpu's DeviceGactEngine(backend="lax") ordered
  records, last_iters, last_active_sum and last_drain_redispatches
  (at least 1) in every tb_format (the port's bytes against darwin_tpu's
  packed6, the word formats each against its own);
* drain off, auto and always give run_gact_batch's record set;
* _drain_tail_span and the gate equal darwin_tpu's on the calibration
  points of test_drain_auto_gate_calibration and on seeded random costs;
* a loop stopped by the drain and resumed from its exported state
  equals one run to completion: records, iterations, active slots;
* ShardedGactEngine never drains.
"""

import numpy as np
import pytest

from darwin_tpu.engine import device_batch as jdb
from darwin_tpu.engine.batch import GactCalls as JaxGactCalls
from darwin_tpu.engine.seqbank import SeqBank as JaxSeqBank
from darwin_tpu.index.genome import Genome as JaxGenome
from darwin_tpu.io.fasta import FastaRecord as JaxFastaRecord
from darwin_tpu_torch.engine import device_batch as tdb
from darwin_tpu_torch.engine.aligner import TorchTileAligner
from darwin_tpu_torch.engine.batch import GactCalls, run_gact_batch
from darwin_tpu_torch.engine.scoring import ScoreParams
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.io.fasta import FastaRecord
from darwin_tpu_torch.parallel.mesh import make_mesh
from tests._torch_threads import one_torch_thread  # noqa: F401

SCORING = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
ENGINE_KW = dict(tile_size=16, early_terminate=8,
                 first_tile_score_threshold=4, same_file=False,
                 batch_size=256, **SCORING)


def _workload():
    """(ref_seq, reads, anchors' arrays): the JAX drain test's."""
    rng = np.random.default_rng(9)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref_seq = alpha[rng.integers(0, 4, size=8192)]
    reads = []
    for i in range(64):
        L = 2000 if i % 16 == 0 else int(rng.integers(120, 400))
        s = int(rng.integers(0, 8192 - L))
        r = ref_seq[s:s + L].copy()
        mut = rng.random(L) < 0.1
        r[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
        reads.append(r)
    N = 600
    qid = rng.integers(0, 64, N).astype(np.int64)
    ref_pos = rng.integers(0, 8000, N).astype(np.int64)
    lens = np.array([len(r) for r in reads])
    query_pos = np.minimum(lens[qid] // 2, 100).astype(np.int64)
    return ref_seq, reads, (np.zeros(N, np.int64), qid, ref_pos, query_pos)


def _key(r):
    return (r.ref_id, r.query_id, r.ab, r.ae, r.bb, r.be, r.score, r.comp,
            r.nmatch, r.ncols)


@pytest.fixture(scope="module")
def drain_case():
    """The port's genome, bank and calls, and darwin_tpu's results under
    auto for packed and packed6, each computed once."""
    ref_seq, reads, arrays = _workload()
    jeng_in = (JaxGenome([JaxFastaRecord(["g"], ref_seq.tobytes().decode())],
                         64), JaxSeqBank(reads))
    want = {}
    for fmt in ("packed", "packed6"):
        eng = jdb.DeviceGactEngine(*jeng_in, backend="lax", tb_format=fmt,
                                   **ENGINE_KW)
        recs = eng.finish(eng.run_async(JaxGactCalls(*arrays), False))
        want[fmt] = ([_key(r) for r in recs], eng.last_iters,
                     eng.last_active_sum, eng.last_drain_redispatches)
    genome = Genome([FastaRecord(["g"], ref_seq.tobytes().decode())], 64)
    return genome, SeqBank(reads), GactCalls(*arrays), want


def _engine(genome, bank, **kw):
    return tdb.DeviceGactEngine(genome, bank, device="cpu",
                                **{**ENGINE_KW, **kw})


@pytest.mark.parametrize("fmt", ["bytes", "packed", "packed6"])
def test_drain_matches_darwin_tpu_ordered(drain_case, fmt):
    genome, bank, calls, want = drain_case
    eng = _engine(genome, bank, tb_format=fmt)
    recs = eng.finish(eng.run_async(calls, False))
    w_recs, w_iters, w_act, w_redis = want["packed6" if fmt == "bytes"
                                           else fmt]
    assert w_redis >= 1 and eng.last_drain_redispatches == w_redis
    assert eng.last_drain_gate is not None
    assert (eng.last_iters, eng.last_active_sum) == (w_iters, w_act)
    assert [_key(r) for r in recs] == w_recs and recs


@pytest.mark.parametrize("drain,gate", [(False, True), (True, True),
                                        (True, False)],
                         ids=["off", "auto", "always"])
def test_every_drain_mode_gives_the_host_engines_set(drain_case, drain,
                                                     gate):
    genome, bank, calls, _ = drain_case
    eng = _engine(genome, bank, drain=drain, drain_gate=gate)
    recs = eng.finish(eng.run_async(calls, False))
    assert eng.last_drain_redispatches == int(drain)
    aligner = TorchTileAligner(early_terminate=8, device="cpu",
                               tile_size=16, **SCORING)
    host = run_gact_batch(genome, bank, calls, tile_size=16,
                          first_tile_score_threshold=4,
                          sp=ScoreParams(1, -1, -1, -1), complement=False,
                          same_file=False, aligner=aligner, batch_size=256)
    assert sorted(map(_key, recs)) == sorted(map(_key, host)) and host


def _jax_gate(costs, B):
    tail, total = jdb._drain_tail_span(costs, B)
    return (tail, total, tail >= jdb.DRAIN_MIN_TAIL_ITERS
            and tail >= jdb.DRAIN_MIN_TAIL_FRAC * total)


def _gate(costs, B):
    tail, total = tdb._drain_tail_span(costs, B)
    return tail, total, tdb.gate_engages(tail, total)


def _calibration_points():
    """test_drain_auto_gate_calibration's three cost arrays and slot
    counts, then seeded random ones."""
    rng = np.random.default_rng(0)
    skew = rng.integers(17, 53, size=600)
    skew[::16] = 252
    moderate = np.where(rng.random(3000) < 0.15, 52, 12)
    points = [(np.full(1100, 10_000 // 256 + 2), 512), (skew, 256),
              (moderate, 2048)]
    rng = np.random.default_rng(5)
    for _ in range(20):
        n = int(rng.integers(1, 3000))
        costs = rng.integers(2, int(rng.integers(3, 300)), size=n)
        costs[rng.random(n) < rng.random() * 0.2] *= 8
        points.append((costs, int(rng.choice([64, 256, 512, 2048]))))
    return points


def test_gate_equals_darwin_tpus():
    points = _calibration_points()
    got = [_gate(c, B) for c, B in points]
    assert got == [_jax_gate(c, B) for c, B in points]
    assert [g[2] for g in got[:3]] == [False, True, False]
    assert any(g[2] for g in got[3:]) and not all(g[2] for g in got[3:])
    assert (tdb.DRAIN_MIN_TAIL_ITERS, tdb.DRAIN_MIN_TAIL_FRAC) == (
        jdb.DRAIN_MIN_TAIL_ITERS, jdb.DRAIN_MIN_TAIL_FRAC)


def test_drain_threshold_follows_the_flags(drain_case):
    """The gate applies where darwin_tpu's does (N > B >= 256), at B/4."""
    genome, bank, calls, _ = drain_case
    bid = calls.query_id
    eng = _engine(genome, bank)
    assert eng.drain_threshold(bid, 256) == 64
    assert eng.drain_threshold(bid, 128) == 0      # B < 256
    assert eng.drain_threshold(bid[:256], 256) == 0  # N <= B
    assert eng.last_drain_gate is None
    eng.drain_gate = False
    assert eng.drain_threshold(bid, 384) == 96
    eng.drain = False
    assert eng.drain_threshold(bid, 256) == 0


def test_fresh_state_equals_darwin_tpus(drain_case):
    _, _, calls, _ = drain_case
    np.testing.assert_array_equal(
        tdb.fresh_state(calls.ref_pos, calls.query_pos),
        jdb.DeviceGactEngine._fresh_state(calls.ref_pos, calls.query_pos))
    assert tdb.CSTATE_COLS[tdb.DONE] == "done" and tdb.DONE == 8


def test_stopped_and_resumed_equals_one_run(drain_case):
    """The first tier's exported state resumed in a loop of its own gives
    the records, iterations and active slot-iterations of a loop that
    never stops."""
    genome, bank, calls, _ = drain_case
    eng = _engine(genome, bank)
    N = len(calls)
    meta = (calls.ref_id, calls.query_id, calls.query_id,
            np.zeros(N, np.int64))
    cs = tdb.fresh_state(calls.ref_pos, calls.query_pos)
    whole = eng._loop(meta, cs, 0)
    assert whole.calls_done == N and whole.state is None
    first = eng._loop(meta, cs, 64)
    assert first.calls_done < N and first.state.shape == (N, 16)
    state = first.state.numpy()
    idx = np.flatnonzero(state[:, tdb.DONE] == 0)
    assert 0 < len(idx) < 64
    rest = eng._loop(tuple(m[idx] for m in meta), state[idx], 0)
    assert first.iters + rest.iters == whole.iters
    assert first.act_sum + rest.act_sum == whole.act_sum

    # The second tier holds the stragglers in other slots, so the
    # records within an iteration may come out in another order.
    def rows(out):
        return out.records[:int(out.nrec)].tolist()
    assert sorted(rows(first) + rows(rest)) == sorted(rows(whole))


def test_sharded_engine_never_drains(drain_case):
    genome, bank, calls, want = drain_case
    eng = tdb.ShardedGactEngine(genome, bank, mesh=make_mesh(
        devices=["cpu"]), tb_format="packed6", **ENGINE_KW)
    assert [e.drain for e in eng.engines] == [False]
    recs = eng.finish(eng.run_async(calls, False))
    assert eng.engines[0].last_drain_redispatches == 0
    assert eng.last_drain_redispatches == 0
    assert sorted(map(_key, recs)) == sorted(want["packed6"][0])
