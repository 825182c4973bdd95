"""chr1_map.chunk16k from its two data files alone, at a CPU rehearsal's
size: a copy of the cell's configuration and traffic with one piece of
12 kb and batches of 12 reads, run untraced and traced through the
cell's BENCHMARK.json entries (traced, with engine_build_ms_per_mbp
listed for it too), its check's control and faults (test_bench_faults')
planted under it; and the reader of the engine build."""

import importlib
import io
import json
import re

import pytest

from benchmark import harness
from benchmark.control import control_mismatches
from _cells import SEED
from test_bench_faults import (an_answer_altered, half_the_calls,
                               state_unchanged)

SPEC = harness.load_spec()
CELL = "chr1_map.chunk16k"
PIECE = 12000
LENGTHS = {"kind": "lognormal", "mean": 1000, "sd": 300, "min": 600,
           "max": 1600, "reads": 12}


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    """The cell's data files, scaled, in a benchmark folder of their
    own."""
    c = harness.load_cell(CELL, SPEC)
    here = tmp_path_factory.mktemp("chr1") / "benchmark"
    (here / "configs").mkdir(parents=True)
    (here / "workloads").mkdir()
    cfg = {**c["config"], "reference": {"pieces": [PIECE]}}
    traffic = {**c["traffic"], "lengths": LENGTHS}
    (here / "configs" / "chr1_map.json").write_text(json.dumps(cfg))
    (here / "workloads" / f"{CELL}.json").write_text(json.dumps(traffic))
    return here


def test_the_cell_is_a_map_job_on_the_device_dsoft():
    c = harness.load_cell(CELL, SPEC)
    cfg, traffic = c["config"], c["traffic"]
    assert harness.job_kind(cfg) == "map" and c["cell"]["chips"] == 1
    assert cfg["reference"] == {"pieces": [248956422]}
    assert (cfg["engine"], cfg["dsoft"], cfg["batch_size"]) == (
        "device", "device", 16384)
    assert traffic["lengths"]["reads"] == 16384
    same = harness.load_cell("ecoli10x_self.lognormal", SPEC)
    assert cfg["params"] == same["config"]["params"]


def listing_engine_build(spec: dict) -> dict:
    """spec with the cell in engine_build_ms_per_mbp's workloads: the
    span is new in the map job, so the cell lists it once the parent
    commit writes it too."""
    spec = json.loads(json.dumps(spec))
    m = next(m for m in spec["per_layer"]
             if m["name"] == "engine_build_ms_per_mbp")
    m["workloads"].append(CELL)
    return spec


@pytest.mark.parametrize("trace", [0, 1])
def test_the_scaled_cell_runs_on_the_cpu(here, trace):
    log = io.StringIO()
    spec = listing_engine_build(SPEC) if trace else SPEC
    r = harness.run_cell(CELL, SEED, 0.0, bool(trace), device="cpu",
                         spec=spec, here=here, log=log)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] == 1
    assert r["checks"]["record_mismatches"] == {"value": 0, "limit": 0}
    assert r["checks"]["reference_records"]["value"] >= 12
    # The warm-up job uploaded the genome's bank; the window's job
    # builds its engine over the resident one.
    job = re.search(r"^job 1: .*$", log.getvalue(), re.M).group(0)
    assert "genome_bank_uploads 0," in job and "engine_build_s" in job
    if trace:
        listed = {m["name"] for m in spec["per_layer"]
                  if CELL in m.get("workloads", [CELL])}
        # On the CPU only the program's spans and counters read.
        assert set(r["metrics"]) == listed - {
            "dp_roofline_pct", "device_idle_pct", "launches_per_iter"}
        assert r["metrics"]["engine_build_ms_per_mbp"]["value"] > 0
        assert r["metrics"]["dsoft_device_ms_per_mbp"]["value"] > 0
    else:
        assert set(r["metrics"]) == {"read_mbp_per_s", "setup_s"}


def test_the_scaled_cells_control_fails(here):
    r = control_mismatches(CELL, SEED, "cpu", spec=SPEC, here=here)
    assert r["reference_records"] >= 1 and r["record_mismatches"] > 0


@pytest.mark.parametrize("fault", [half_the_calls, an_answer_altered,
                                   state_unchanged])
def test_a_fault_in_the_scaled_cell_is_not_correct(here, fault,
                                                   monkeypatch):
    fault(monkeypatch)
    r = harness.run_cell(CELL, SEED, 0.0, False, device="cpu", spec=SPEC,
                         here=here, log=io.StringIO())
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["record_mismatches"]["value"] > 0


def test_the_engine_build_reader_reads_its_span_or_nothing():
    reader = importlib.import_module(
        "benchmark.metrics.engine_build_ms_per_mbp")
    trace = dict(mbp=2.0, sums={"align_s": 9.0})
    assert reader.read(trace) is None
    trace["sums"]["engine_build_s"] = 0.5
    assert reader.read(trace) == pytest.approx(250.0)
    trace["mbp"] = 0.0
    assert reader.read(trace) is None
