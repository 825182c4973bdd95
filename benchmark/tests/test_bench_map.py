"""The two job kinds: the self job's inputs pinned to a digest, and the
map job (batches of reads against a resident reference): its reads'
names, its set-up, its check and a new map cell made of data files."""

import hashlib
import importlib
import json
import re

import numpy as np
import pytest

from benchmark import harness, readgen
from benchmark.reference import overlap
from _cells import HERE, MAP, SCALES, SEED, where

SPEC = harness.load_spec()
SELF = "ecoli10x_self.lognormal"
# ecoli10x_self.lognormal's inputs at SCALES and SEED before the map job
# was added: names, bases, lengths and the check's sample of each input.
SELF_DIGEST = "b7d067b9d3fa8654af94ce049549822e4009ee0c1f495b4f1a45111169439c32"
NAME = re.compile(r"c(\d+)R(\d+)_(\d+)_(\d+)(_c)?$")
COMP = np.frombuffer(b"TGCA", dtype=np.uint8)


def map_cell(**traffic):
    c = harness.load_cell(MAP, where(MAP, SPEC)["spec"], HERE)
    return c["config"], {**c["traffic"], **traffic}


def test_the_self_jobs_inputs_are_pinned():
    c = harness.load_cell(SELF, SPEC)
    pieces, pool = harness.make_data(c["config"], c["traffic"], SEED,
                                     SCALES["ecoli10x_self"])
    assert pieces is None and harness.job_kind(c["config"]) == "self"
    h = hashlib.sha256()
    for j, inp in enumerate(pool):
        h.update("\n".join(inp.names).encode())
        h.update(inp.flat.tobytes())
        h.update(inp.lengths.astype("<i8").tobytes())
        h.update(repr(harness.sample_reads(inp, c["traffic"]["check"], SEED,
                                           j)).encode())
    assert h.hexdigest() == SELF_DIGEST


def test_a_read_name_places_it_on_its_piece():
    exact = {"mean": 1.0, "sd": 0, "min": 1.0, "max": 1.0}
    cfg, traffic = map_cell(accuracy=exact)
    pieces, pool = harness.make_data(cfg, traffic, SEED)
    sizes = cfg["reference"]["pieces"]
    assert [len(s) for _, s in pieces] == sizes
    assert [n for n, _ in pieces] == [f"chr{p}" for p in range(len(sizes))]
    from darwin_tpu_torch.eval.sensitivity import measure_sensitivity_guided
    for inp in pool:
        on = np.zeros(len(sizes), dtype=np.int64)
        records = {p: [] for p in range(len(sizes))}
        for i, name in enumerate(inp.names):
            p, _, start, ln, comp = NAME.match(name).groups()
            p, start, ln = int(p), int(start), int(ln)
            src = pieces[p][1][start:start + ln]
            want = COMP[readgen.BASES.searchsorted(src)][::-1] if comp \
                else src
            assert ln == len(inp.seq(i)) and (inp.seq(i) == want).all()
            on[p] += 1
            records[p].append(overlap.record_line(
                f"chr{p}", name, start, start + ln, 0, ln, ln, int(bool(comp))))
        # In proportion to the pieces' lengths, and placed by eval's
        # +/-50 bp mode one piece at a time.
        assert (on == readgen.shares(len(inp.names), sizes)).all()
        for p, recs in records.items():
            r = measure_sensitivity_guided(recs, len(recs), score_thres=0)
            assert r.tp == len(recs) and r.fp == r.fn == 0


def test_shares_follow_the_pieces_lengths():
    assert readgen.shares(10, [3, 3, 4]).tolist() == [3, 3, 4]
    assert readgen.shares(16384, [125_000_000] * 24).tolist() == \
        [683] * 16 + [682] * 8
    assert readgen.shares(7, [248_956_422]).tolist() == [7]
    assert readgen.shares(5, [1, 1000, 1]).tolist() == [0, 5, 0]


def test_a_read_longer_than_a_piece_is_refused():
    cfg, traffic = map_cell()
    cfg = {**cfg, "reference": {"pieces": [9000, 1000]}}
    with pytest.raises(ValueError, match="longer than a piece"):
        harness.make_data(cfg, traffic, SEED)


def test_an_unknown_job_kind_is_refused():
    with pytest.raises(ValueError, match="self or map"):
        harness.job_kind({"job": "chunk"})


def test_the_reference_is_built_once_in_set_up(monkeypatch):
    from darwin_tpu_torch import pipeline
    calls = {"Genome": 0, "build": 0, "run_pipeline": 0}
    genome, build = pipeline.Genome, pipeline.SeedTable.build

    def counted(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f
    monkeypatch.setattr(pipeline, "Genome", counted("Genome", genome))
    monkeypatch.setattr(pipeline.SeedTable, "build",
                        counted("build", build))
    monkeypatch.setattr(pipeline, "run_pipeline",
                        counted("run_pipeline", pipeline.run_pipeline))
    r = harness.run_cell(MAP, SEED, 0.0, False, device="cpu",
                         **where(MAP, SPEC))
    # Set-up, the warm-up job and one job of the window.
    assert r["correct"] is True and r["attempted"] == 1
    assert calls == {"Genome": 1, "build": 1, "run_pipeline": 0}


def test_the_check_builds_one_index_for_every_batch(monkeypatch):
    cfg, traffic = map_cell()
    pieces, pool = harness.make_data(cfg, traffic, SEED)
    built = []
    init = overlap.SeedIndex.__init__

    def counted(self, *a, **kw):
        built.append(1)
        init(self, *a, **kw)
    monkeypatch.setattr(overlap.SeedIndex, "__init__", counted)
    ck = harness.check(cfg, traffic, pieces, pool, [(0, []), (1, []),
                                                    (0, [])], SEED, "cpu")
    assert len(built) == 1
    assert ck["sampled_reads"] == sum(len(p.names) for p in pool)
    assert ck["failed_jobs"] == 3 and ck["record_mismatches"] > 0


@pytest.mark.parametrize("engine,dsoft", [("device", "host"),
                                          ("host", "host")])
def test_a_new_map_cell_takes_only_data_files(tmp_path, engine, dsoft):
    here = tmp_path / "benchmark"
    (here / "configs").mkdir(parents=True)
    (here / "workloads").mkdir()
    cfg, traffic = map_cell()
    cfg = {**cfg, "name": "twopiece", "engine": engine, "dsoft": dsoft,
           "reference": {"pieces": [7000, 5000]}}
    traffic["lengths"] = {"kind": "fixed", "length": 2000, "reads": 6}
    (here / "configs" / "twopiece.json").write_text(json.dumps(cfg))
    (here / "workloads" / "twopiece.fixed2k.json").write_text(
        json.dumps(traffic))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "twopiece.fixed2k",
                              "config": "twopiece", "traffic": "fixed2k",
                              "chips": 1, "why": "every read 2 kb"})
    r = harness.run_cell("twopiece.fixed2k", SEED, 0.0, False, device="cpu",
                         spec=spec, here=here)
    assert r["correct"] is True
    assert r["checks"]["reference_records"]["value"] >= 6


def test_a_traced_map_job_reads_its_layers():
    kw = where(MAP, SPEC)
    r = harness.run_cell(MAP, SEED, 0.0, True, device="cpu", **kw)
    assert r["correct"] is True
    # On the CPU only the program's spans and counters read; the seed
    # table is set-up and host D-SOFT does not run.
    assert set(r["metrics"]) == {
        "align_ms_per_mbp", "slot_occupancy_pct", "format_ms_per_mbp",
        "read_banks_ms_per_mbp", "engine_prepare_ms_per_mbp",
        "engine_enqueue_ms_per_mbp", "engine_wait_ms_per_mbp",
        "engine_records_ms_per_mbp", "dsoft_device_ms_per_mbp"}


def test_the_device_dsoft_reader_reads_device_seeding_only():
    reader = importlib.import_module(
        "benchmark.metrics.dsoft_device_ms_per_mbp")
    trace = dict(mbp=2.0, sums={"seed_s": 0.5},
                 cell={"config": {"dsoft": "device"}})
    assert reader.read(trace) == pytest.approx(250.0)
    trace["cell"]["config"]["dsoft"] = "host"
    assert reader.read(trace) is None
