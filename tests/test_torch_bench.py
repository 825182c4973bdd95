"""darwin_tpu_torch.bench, the counterpart of bench.py, on the CPU.

* python -m darwin_tpu_torch.bench --device cpu at B = 8, T = 32 / ET =
  16, V = 2 prints one JSON line whose keys are bench.py's, with a
  positive value and step_ms = dp_ms + traceback_ms;
* its step sink (bench.one_step) equals the sink of darwin_tpu's
  align_tiles_jax + pack_dir_words6 + traceback_packed6_jax composition
  (bench.py's one_step) on the same NumPy inputs, batch by batch, in the
  kernels' wrappers and in their plain versions;
* without --device cpu and with no card it exits nonzero and prints no
  JSON line.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu.ops.traceback import pack_dir_words6, traceback_packed6_jax
from darwin_tpu_torch import bench
from darwin_tpu_torch.lab import SCORING, wrap32
from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "-B", "8", "-T", "32/16", "24/12", "-V", "2"]


def _bench_py_keys() -> set:
    """The keys of the JSON line bench.py's main prints."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)}
            if {"metric", "tile_size"} <= keys:
                return keys
    raise AssertionError("bench.py prints no JSON line")


def _run(*args, **env):
    return subprocess.run([sys.executable, "-m", "darwin_tpu_torch.bench",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, **env})


def test_bench_prints_bench_py_keys_on_cpu():
    r = _run(*SMALL)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == _bench_py_keys()
    assert out["metric"] == "gact_gcups" and out["unit"] == "GCUPS"
    assert out["value"] > 0 and out["gcups_ref_geom_t320"] > 0
    assert out["tile_size"] == 32
    assert out["step_ms"] == pytest.approx(out["dp_ms"]
                                           + out["traceback_ms"])
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / bench.BASELINE_CPU_KERNEL_GCUPS)
    assert "sink" in r.stderr


def test_bench_without_a_card_exits_nonzero():
    r = _run(CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and not r.stdout.strip()


def _jax_one_step(refs, queries, firsts, et) -> int:
    """bench.py's one_step on the lax path, int32 as its scan carry."""
    B, T = refs.shape
    rlen = np.full(B, T, dtype=np.int32)
    out = align_tiles_jax(refs, queries, rlen, rlen, **SCORING)
    ops, _mb, i_s, j_s = traceback_packed6_jax(
        pack_dir_words6(out["dir"]), rlen, rlen, firsts, out["max_i"],
        out["max_j"], early_terminate=et)
    return int(ops.astype(jnp.int32).sum() + i_s.sum() + j_s.sum()
               + out["max_score"].sum())


@pytest.mark.parametrize("B,T,et", [(8, 32, 16), (6, 24, 40)])
def test_step_sink_equals_darwin_tpus_composition(B, T, et):
    b = bench.Batches(torch.device("cpu"), B, T, 2)
    firsts = b.firsts.numpy()
    for v in range(2):
        want = _jax_one_step(b.refs[v].numpy(), b.queries[v].numpy(),
                             firsts, et)
        assert wrap32(int(bench.one_step(b, v, et))) == want
        assert wrap32(int(bench.one_step(b, v, et, plain=True))) == want
