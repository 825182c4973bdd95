"""The readers of the program's own spans inside the device engine and
the host stages (read_banks_s, engine_prepare_s, engine_enqueue_s,
engine_wait_s, engine_records_s, format_s).  BENCHMARK.json lists all
six for the cell; a traced CPU rehearsal reads all six, and each reads
nothing where the program wrote no such span."""

import importlib

import pytest

from benchmark import harness
from _cells import SCALES, SEED

SPEC = harness.load_spec()
CELL = "ecoli10x_self.lognormal"
LAYERS = {"read_banks_ms_per_mbp": "read banks",
          "engine_prepare_ms_per_mbp": "device engine (host preparation)",
          "engine_enqueue_ms_per_mbp": "device engine (launches)",
          "engine_wait_ms_per_mbp": "device engine (stop-check wait)",
          "engine_records_ms_per_mbp": "device engine (records)",
          "format_ms_per_mbp": "records formatting"}
KEYS = {name: name.replace("_ms_per_mbp", "_s") for name in LAYERS}
ENGINE = [n for n in LAYERS if n.startswith("engine_")]


def entries() -> list[dict]:
    """The six metrics' BENCHMARK.json entries."""
    return [{"name": name, "unit": "ms/Mbp", "better": "lower",
             "source": "program_span", "layer": layer,
             "moves": "read_mbp_per_s", "workloads": [CELL]}
            for name, layer in LAYERS.items()]


def test_the_listed_entries_read_the_cell():
    listed = [m for m in SPEC["per_layer"] if m["name"] in LAYERS]
    assert sorted(m["name"] for m in listed) == sorted(LAYERS)
    assert all(m in entries() for m in listed)


def test_a_traced_rehearsal_reads_every_span():
    listed = {m["name"] for m in SPEC["per_layer"]}
    spec = {**SPEC, "per_layer": SPEC["per_layer"] + [
        m for m in entries() if m["name"] not in listed]}
    r = harness.run_cell(CELL, SEED, 0.0, True, device="cpu",
                         scale=SCALES["ecoli10x_self"], spec=spec)
    assert r["correct"] is True
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(LAYERS) <= got.keys()
    assert all(got[n] >= 0 for n in LAYERS)
    assert sum(got[n] for n in ENGINE) <= got["align_ms_per_mbp"] * (1
                                                                     + 1e-9)
    assert all(r["metrics"][n]["unit"] == "ms/Mbp" for n in LAYERS)


@pytest.mark.parametrize("name", list(LAYERS))
def test_a_reader_reads_its_span_or_nothing(name):
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    trace = dict(mbp=2.0, sums={})
    assert reader.read(trace) is None
    trace["sums"] = {KEYS[name]: 0.5, "align_s": 9.0}
    assert reader.read(trace) == pytest.approx(250.0)
