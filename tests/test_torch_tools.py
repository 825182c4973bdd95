"""The port's profiling and geometry tools (tools/torch_*.py) on the CPU,
each held to darwin_tpu at a tiny size:

* torch_tile_geom: its step chain's sink equals the sum of darwin_tpu's
  align_tiles_jax + pack_dir_words6 + traceback_packed6_jax (tools/
  tile_geom.py's full step) over the same V batches, int32-wrapped;
* torch_profile kernel: its step sink equals the same composition on
  tools/profile.py's inputs (no first tiles, ET 200); pipeline on
  tests/data/tiny, with and without --trace-dir: the reference binary's
  records, a trace file, and a phase split no larger than the wall;
* torch_engine_prof: its records under compute_score True and False
  equal darwin_tpu's DeviceGactEngine (lax) on the same arrays;
* torch_geom_e2e_ab: each tile size's record set equals darwin_tpu's
  run_pipeline at that size;
* torch_scaling_run: PARITY: EXACT over 1 and 2 gloo processes, and the
  one process's merge equals python -m darwin_tpu.cli's;
* each tool exits nonzero with --device cuda and no card.

Every comparison is exact (sinks after the int32 wrap, record sets).
Each tool runs in this process with --device cpu (the kernels' plain
versions); tools that align take the tiny fixture's params (T = 64).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from darwin_tpu.config import Params as JaxParams
from darwin_tpu.engine import device_batch as jdb
from darwin_tpu.engine.batch import GactCalls as JaxGactCalls
from darwin_tpu.engine.seqbank import SeqBank as JaxSeqBank
from darwin_tpu.index.genome import Genome as JaxGenome
from darwin_tpu.io.fasta import FastaRecord as JaxFastaRecord
from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu.ops.traceback import pack_dir_words6, traceback_packed6_jax
from darwin_tpu.pipeline import run_pipeline as jax_run_pipeline
from darwin_tpu_torch.lab import (SCORING, launch_counters, related_batches,
                                  wrap32)
from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY = REPO / "tests" / "data" / "tiny"
CPU = torch.device("cpu")

sys.path.insert(0, str(REPO / "tools"))
import torch_engine_prof as engine_prof  # noqa: E402
import torch_geom_e2e_ab as geom_ab  # noqa: E402
import torch_profile as profile  # noqa: E402
import torch_scaling_run as scaling_run  # noqa: E402
import torch_tile_geom as tile_geom  # noqa: E402

# A self-overlap dataset small enough for the plain versions at T = 64.
SMALL_DATASET = ["--genome", "12000", "--reads", "6", "--read-len", "1500"]


def _jax_step_sink(refs, queries, firsts, et) -> int:
    """tools/tile_geom.py's full_step (and profile.py's step) on the lax
    path: the walker's ops, i and j steps and the max scores summed."""
    B, T = refs.shape
    rlen = np.full(B, T, dtype=np.int32)
    out = align_tiles_jax(refs, queries, rlen, rlen, **SCORING)
    ops, _mb, i_s, j_s = traceback_packed6_jax(
        pack_dir_words6(out["dir"]), rlen, rlen, firsts, out["max_i"],
        out["max_j"], early_terminate=et)
    return int(ops.astype(jnp.int32).sum() + i_s.sum() + j_s.sum()
               + out["max_score"].sum())


@pytest.mark.parametrize("T,et", [(32, 16), (48, 200)])
def test_tile_geom_sink_equals_darwin_tpus_step(T, et, capsys):
    B, V = 8, 2
    assert tile_geom.main([str(T), str(et), "-B", str(B), "-V", str(V),
                           "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"T={T} ET={et} step_ms=") and "gcups=" in line
    refs, queries = related_batches(V, B, T)
    firsts = np.zeros(B, dtype=bool)
    firsts[: B // 2] = True
    want = wrap32(sum(_jax_step_sink(refs[v], queries[v], firsts, et)
                      for v in range(V)))
    assert line.endswith(f" sink={want}")
    r = tile_geom.probe(CPU, T, et, B, V)
    assert r["sink"] == want and r["gcups"] > 0 and r["dp_ms"] > 0


def test_profile_kernel_sink_equals_darwin_tpus_step(tmp_path):
    r = profile.profile_kernel(CPU, 8, 32, reps=2, trace_dir=tmp_path)
    refs, queries = related_batches(1, 8, 32)
    want = _jax_step_sink(refs[0], queries[0], np.zeros(8, dtype=bool),
                          profile.KERNEL_ET)
    assert r["sink"] == wrap32(want) and r["gcups"] > 0
    assert (tmp_path / profile.TRACE_FILE).stat().st_size > 0
    assert r["summary"] is None  # a CPU run reports no device share


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
def test_profile_pipeline_on_tiny(traced, tmp_path, capsys):
    reads = str(TINY / "reads.fasta")
    trace = tmp_path / "trace" if traced else None
    r = profile.profile_pipeline(CPU, reads, reads, str(TINY / "params.cfg"),
                                 reps=1, trace_dir=trace)
    want = set((TINY / "out.darwin").read_text().splitlines())
    assert set(r["records"]) == want
    assert 0 < r["phases_s"] <= r["wall"]
    assert set(profile.PHASES) <= r["metrics"].keys()
    assert r["metrics"]["engine_iters"] > 0
    out = capsys.readouterr().out
    assert f"{len(r['records'])} records" in out and " other " in out
    if traced:
        assert (trace / profile.TRACE_FILE).stat().st_size > 0
        assert "device share not measured" in out


def _key(r):
    return (r.ref_id, r.query_id, r.ab, r.ae, r.bb, r.be, r.score, r.comp,
            r.nmatch, r.ncols)


def test_engine_prof_records_equal_darwin_tpus_engine():
    w = engine_prof.synthetic_calls(8, 50_000, 1200)
    # The tool reads the shared launch counters and never resets them
    # (a caller such as chip_smoke counts over the whole run).
    counters = launch_counters()
    saved = {k: c.launches for k, c in counters.items()}
    try:
        for i, c in enumerate(counters.values()):
            c.launches = 100 + i
        held = {k: c.launches for k, c in counters.items()}
        got = engine_prof.profile_engine(CPU, w, reps=1)
        assert {k: c.launches for k, c in counters.items()} == held
    finally:
        for k, c in counters.items():
            c.launches = saved[k]
    assert got[True]["launches"] == dict.fromkeys(
        engine_prof.ENGINE_KERNELS, 0)  # the CPU launches no kernel
    n = len(w["reads"])
    genome = JaxGenome([JaxFastaRecord(["ref"], w["genome"])], 64)
    calls = JaxGactCalls(np.zeros(n, np.int64), np.arange(n, dtype=np.int64),
                         w["ref_pos"], w["query_pos"])
    for score in (True, False):
        eng = jdb.DeviceGactEngine(
            genome, JaxSeqBank(w["reads"]), tile_size=engine_prof.TILE,
            early_terminate=200,
            first_tile_score_threshold=engine_prof.THRESHOLD,
            same_file=False, batch_size=n, compute_score=score,
            backend="lax", **SCORING)
        want = {_key(r) for r in eng.run(calls, False)}
        assert {_key(r) for r in got[score]["records"]} == want
        assert len(want) > 0 and got[score]["iters"] > 0


def test_geom_e2e_ab_records_equal_darwin_tpus_pipeline(capsys):
    args = geom_ab.parse_args(["--tiles", "64,96", "--reps", "1",
                               *SMALL_DATASET, "--batch-size", "64",
                               "--params", str(TINY / "params.cfg"),
                               "--device", "cpu"])
    refs, reads = geom_ab.dataset(args)
    res = geom_ab.run_ab(args, CPU, refs, reads)
    jreads = [JaxFastaRecord(r.fields, r.seq) for r in reads]
    for t in (64, 96):
        params = JaxParams.from_cfg(TINY / "params.cfg")
        params.tile_size = t
        want = jax_run_pipeline(jreads, jreads, params, same_file=True,
                                batch_size=64, engine="host")
        assert res[t]["records"] == sorted(set(want.records))
        assert res[t]["records"] and len(res[t]["walls"]) == 1
        assert res[t]["best_s"] <= res[t]["median_s"]


def test_scaling_run_parity_and_darwin_tpu_cli(tmp_path, capsys):
    work = tmp_path / "work"
    assert scaling_run.main(["--procs", "2", *SMALL_DATASET, "--params",
                             str(TINY / "params.cfg"), "--batch-size", "64",
                             "--device", "cpu", "--workdir", str(work)]) == 0
    out = capsys.readouterr().out
    assert "PARITY: EXACT" in out and "projected efficiency" in out
    got = (work / "p1" / "merged.0.out").read_text().splitlines()
    assert got
    jout = tmp_path / "jax"
    jout.mkdir()
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO), os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, "-m", "darwin_tpu.cli",
                        str(work / "reads.fasta"), str(work / "reads.fasta"),
                        "--params", str(TINY / "params.cfg"),
                        "--batch-size", "64", "--merged-out",
                        str(jout / "merged.out")], cwd=jout, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert got == (jout / "merged.out").read_text().splitlines()


@pytest.mark.parametrize("tool,argv", [
    (tile_geom, ["320"]),
    (profile, ["kernel", "8", "32"]),
    (profile, ["pipeline", str(TINY / "reads.fasta"),
               str(TINY / "reads.fasta")]),
    (engine_prof, ["8"]),
    (geom_ab, []),
    (scaling_run, []),
], ids=["tile_geom", "profile_kernel", "profile_pipeline", "engine_prof",
        "geom_e2e_ab", "scaling_run"])
def test_tool_without_a_card_exits_nonzero(tool, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([*argv, "--device", "cuda"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
