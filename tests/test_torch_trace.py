"""The port's tracer (darwin_tpu_torch/spans.py) and its spans in the
pipeline and the device engine, on the CPU:

* run_pipeline on tiny with metrics={} adds every span and counter,
  each >= 0, the engine's four spans inside align_s and genome_s and
  read_banks_s inside genome_banks_s;
* engine_slot_iters is the slots times the iterations of each loop,
  both tiers of a forced drain (test_torch_drain's workload) counted,
  and at least engine_active_sum; the sharded engine sums its entries';
* records are identical with metrics=None, with metrics={} and under
  torch.profiler;
* under the profiler the host-only spans are darwin.* ranges and no
  darwin.* range overlaps a slot loop;
* span's null context, nesting, and a span whose body raises.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from darwin_tpu_torch import spans
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.engine import device_batch as tdb
from darwin_tpu_torch.engine.batch import GactCalls
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.io.fasta import FastaRecord, parse_fasta
from darwin_tpu_torch.parallel.mesh import make_mesh
from darwin_tpu_torch.pipeline import run_pipeline
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_drain import ENGINE_KW, _workload

ENGINE_SPANS = ("engine_prepare_s", "engine_enqueue_s", "engine_wait_s",
                "engine_records_s")
NEW_KEYS = ("genome_s", "read_banks_s", *ENGINE_SPANS, "engine_slot_iters")
# The spans around host work (or one copy) that open profiler ranges on
# the tiny run; align, engine_build and the loop's two are timers only.
RANGED = {"genome_banks", "genome", "read_banks", "table", "seed",
          "format", "engine_prepare", "engine_records"}


def _tiny(data_dir, metrics):
    d = data_dir / "tiny"
    reads = parse_fasta(d / "reads.fasta")
    return run_pipeline(reads, reads, Params.from_cfg(d / "params.cfg"),
                        True, batch_size=32, device="cpu", metrics=metrics)


@pytest.fixture(scope="module")
def profiled_tiny(data_dir):
    """The tiny run's records and metrics under the CPU profiler, its
    darwin.* ranges and the intervals of its slot loops (ns)."""
    loop = tdb.DeviceGactEngine._loop
    loops = []

    def timed(self, meta, cstate, drain):
        with record_function("test.loop") as rf:
            out = loop(self, meta, cstate, drain)
        loops.append(rf)
        return out

    tdb.DeviceGactEngine._loop = timed
    try:
        m = {}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            res = _tiny(data_dir, m)
    finally:
        tdb.DeviceGactEngine._loop = loop
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    ranges = [e for e in events if e[0].startswith(spans.PREFIX)]
    loop_iv = [e[1:] for e in events if e[0] == "test.loop"]
    assert len(loop_iv) == len(loops) >= 1
    return res, m, ranges, loop_iv


def test_run_pipeline_adds_every_span(data_dir):
    m = {}
    res = _tiny(data_dir, m)
    assert res.records
    assert all(m[k] >= 0 for k in NEW_KEYS), m
    assert m["engine_slot_iters"] >= m["engine_active_sum"] > 0
    assert sum(m[k] for k in ENGINE_SPANS) <= m["align_s"]
    assert m["genome_s"] + m["read_banks_s"] <= m["genome_banks_s"]
    assert {"genome_banks_s", "engine_build_s", "table_s", "seed_s",
            "align_s", "format_s", "engine_iters", "engine_active_sum",
            "drain_redispatches"} <= m.keys()


@pytest.mark.parametrize("mode", ["dict", "profiler"])
def test_records_are_the_same_traced_or_not(data_dir, profiled_tiny, mode):
    want = _tiny(data_dir, None).records
    got = (_tiny(data_dir, {}) if mode == "dict"
           else profiled_tiny[0]).records
    assert got == want and want
    assert set(want) == set((data_dir / "tiny" / "out.darwin")
                            .read_text().splitlines())


def test_host_spans_are_ranges_and_none_covers_a_loop(profiled_tiny):
    _, m, ranges, loop_iv = profiled_tiny
    names = {n[len(spans.PREFIX):] for n, _, _ in ranges}
    assert names == RANGED
    assert all(not n.startswith("bench:") and "align_tiles" not in n
               for n, _, _ in ranges)
    for name, s, e in ranges:
        for ls, le in loop_iv:
            assert e <= ls or s >= le, (name, s, e, ls, le)
    assert m["engine_slot_iters"] > 0


@pytest.fixture(scope="module")
def drain_inputs():
    ref_seq, reads, arrays = _workload()
    genome = Genome([FastaRecord(["g"], ref_seq.tobytes().decode())], 64)
    return genome, SeqBank(reads), GactCalls(*arrays)


@pytest.mark.parametrize("kind", ["drain", "sharded"])
def test_slot_iters_count_every_loop(drain_inputs, kind, monkeypatch):
    genome, bank, calls = drain_inputs
    loop = tdb.DeviceGactEngine._loop
    loops = []

    def counted(self, meta, cstate, drain):
        out = loop(self, meta, cstate, drain)
        loops.append(self.slots(len(meta[0])) * out.iters)
        return out

    monkeypatch.setattr(tdb.DeviceGactEngine, "_loop", counted)
    if kind == "drain":
        eng = tdb.DeviceGactEngine(genome, bank, device="cpu", **ENGINE_KW)
    else:
        eng = tdb.ShardedGactEngine(genome, bank, mesh=make_mesh(
            devices=["cpu"] * 2), **ENGINE_KW)
    recs = eng.finish(eng.run_async(calls, False))
    assert recs and len(loops) == 2
    assert eng.last_drain_redispatches == (kind == "drain")
    got = eng.last_spans
    assert got["engine_slot_iters"] == sum(loops)
    assert got["engine_slot_iters"] >= eng.last_active_sum > 0
    assert all(got[k] >= 0 for k in ENGINE_SPANS), got
    # A second run starts its spans afresh.
    eng.finish(eng.run_async(calls, False))
    assert eng.last_spans["engine_slot_iters"] == sum(loops[2:])


@pytest.mark.parametrize("ranged", [True, False])
def test_an_untraced_span_is_the_null_context(ranged):
    assert spans.span(None, "x", ranged=ranged) is spans.NULL
    with profile(activities=[ProfilerActivity.CPU]):
        s = spans.span(None, "x", ranged=ranged)
    assert (s is spans.NULL) is not ranged


@pytest.mark.parametrize("profiled", [False, True])
def test_a_span_records_when_its_body_raises(profiled):
    m = {}
    with (profile(activities=[ProfilerActivity.CPU]) if profiled
          else contextlib.nullcontext()) as prof:
        with pytest.raises(ValueError):
            with spans.span(m, "outer"):
                with spans.span(m, "inner"):
                    raise ValueError("stop")
        with spans.span(m, "inner"):
            pass
    assert 0 <= m["inner_s"] and m.keys() == {"outer_s", "inner_s"}
    if profiled:
        names = [e.name() for e in prof.profiler.kineto_results.events()]
        assert names.count("darwin.inner") == 2
        assert names.count("darwin.outer") == 1


def test_spans_nest_and_counts_add():
    m = {"n": 1}
    with spans.span(m, "outer"):
        with spans.span(m, "inner"):
            torch.ones(4).sum()
    assert 0 <= m["inner_s"] <= m["outer_s"]
    spans.count(m, "n", 2)
    spans.merge(m, {"n": 3, "inner_s": 1.0})
    spans.count(None, "n", 1)
    assert m["n"] == 6 and m["inner_s"] >= 1.0
