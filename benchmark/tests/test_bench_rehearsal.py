"""A rehearsal of the harness on the CPU: every cell, configuration and
metric file is found by name, and each cell's job loop (and the
test-only map cell's) runs once at a tiny size on the port's plain CPU
paths.  The real command refuses to run without a card."""

import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from _cells import MAP, SCALES, SEED, where

ROOT = Path(__file__).resolve().parents[2]
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_every_file_is_found_by_name():
    for w in SPEC["workloads"]:
        c = harness.load_cell(w["name"], SPEC)
        assert c["config"]["name"] == w["config"]
    for cfg in SPEC["configs"]:
        assert (ROOT / cfg["file"]).is_file()
    for m in SPEC["per_layer"]:
        assert callable(importlib.import_module(
            f"benchmark.metrics.{m['name']}").read)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS + [MAP])
def test_a_cell_runs_once_on_the_cpu(cell, trace):
    kw = where(cell, SPEC)
    r = harness.run_cell(cell, SEED, 0.0, bool(trace), device="cpu", **kw)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] == 1
    assert list(r)[-1] == "checks"
    assert r["checks"]["record_mismatches"] == {"value": 0, "limit": 0}
    assert r["checks"]["reference_records"]["value"] >= 1
    if trace:
        want = {m["name"] for m in kw["spec"]["per_layer"]
                if cell in m.get("workloads", [cell])}
        # On the CPU only the program's spans and counters read.
        assert set(r["metrics"]) <= want
        assert "align_ms_per_mbp" in r["metrics"]
        assert "slot_occupancy_pct" in r["metrics"]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {"read_mbp_per_s", "setup_s"}


def test_a_new_cell_takes_only_data_files(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark" / "configs", here / "configs")
    shutil.copytree(ROOT / "benchmark" / "workloads", here / "workloads")
    traffic = json.loads((here / "workloads" /
                          "ecoli10x_self.lognormal.json").read_text())
    traffic["lengths"] = {"kind": "fixed", "length": 10000, "coverage": 10}
    (here / "workloads" / "ecoli10x_self.fixed10k.json").write_text(
        json.dumps(traffic))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "ecoli10x_self.fixed10k",
                              "config": "ecoli10x_self",
                              "traffic": "fixed10k", "chips": 1,
                              "why": "every read 10 kb"})
    scale = {"genome_length": 12000,
             "lengths": {"length": 1500, "coverage": 2}}
    r = harness.run_cell("ecoli10x_self.fixed10k", SEED, 0.0, False,
                         device="cpu", scale=scale, spec=spec, here=here)
    assert r["correct"] is True


def test_the_command_refuses_without_a_card():
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 3 and p.stdout == ""


def test_a_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import harness\n"
            f"harness.run_cell({CELLS[0]!r}, 1, 0.0, False, device='cpu', "
            f"scale={SCALES['ecoli10x_self']!r})")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "darwin_tpu_torch" in p.stderr


@pytest.mark.parametrize("on_card", [False, True])
def test_a_metric_that_reads_nothing_fails_a_run_on_the_card(on_card):
    empty = dict(cell=harness.load_cell(CELLS[0], SPEC), mbp=1.0, sums={},
                 loops=[], dp_calls=[], on_card=on_card,
                 device=dict(kernels={}, launches=0, busy_s=0.0,
                             window_s=0.0))
    if on_card:
        with pytest.raises(SystemExit, match="read nothing"):
            harness.per_layer(SPEC, CELLS[0], empty)
    else:
        assert harness.per_layer(SPEC, CELLS[0], empty) == {}
