"""What the benchmark's processes load: the harness and the program no
JAX and no darwin_tpu; the reference nothing of darwin_tpu_torch either.
Names compare by their top-level part, whole."""

import json
import subprocess
import sys
from pathlib import Path

from benchmark import importcheck

ROOT = Path(__file__).resolve().parents[2]


def loaded_after(code: str) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return json.loads(out.stdout.splitlines()[-1])


def test_names_compare_whole_top_level_parts():
    mods = ["darwin_tpu_torch.pipeline", "numpy", "jax.numpy", "flaxen"]
    assert importcheck.forbidden(mods, importcheck.HARNESS) == ["jax"]
    assert importcheck.forbidden(mods, importcheck.REFERENCE) == [
        "darwin_tpu_torch", "jax"]
    assert importcheck.forbidden(["darwin_tpu.cli"], importcheck.HARNESS) \
        == ["darwin_tpu"]


def test_reference_loads_nothing_of_the_program():
    mods = loaded_after(
        "from benchmark.reference.overlap import reference_records\n"
        "from benchmark.reference.seqio import read_fasta, read_params\n"
        "d = 'tests/data/tiny/'\n"
        "r = read_fasta(d + 'reads.fasta')\n"
        "reference_records(r, r, read_params(d + 'params.cfg'),"
        " same_file=True, read_ids=[0], device='cpu')")
    assert importcheck.forbidden(mods, importcheck.REFERENCE) == []


def test_harness_and_program_load_no_jax():
    mods = loaded_after(
        "from benchmark import harness, control, roofline\n"
        "import benchmark.run\n"
        "from darwin_tpu_torch import pipeline, native\n"
        "from darwin_tpu_torch.engine import device_batch\n"
        "import importlib\n"
        "spec = harness.load_spec()\n"
        "[importlib.import_module('benchmark.metrics.' + m['name'])"
        " for m in spec['per_layer']]")
    assert "darwin_tpu_torch" in {m.split(".")[0] for m in mods}
    assert importcheck.forbidden(mods, importcheck.HARNESS) == []
