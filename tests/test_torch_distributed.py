"""darwin_tpu_torch's multi-process layer (torch.distributed, gloo)
against darwin_tpu's:

* read_range against darwin_tpu's for any process count;
* the single-process paths: allgather_records is sorted(set(...)),
  maybe_initialize is a no-op without configuration, barrier and
  shutdown return;
* allgather_records across two real gloo processes (a file rendezvous
  in the test's own directory, so parallel test workers never share a
  port): the same sorted-unique union on both, skewed and empty inputs,
  and shutdown ends the group so that both processes exit 0;
* the port's CLI with --distributed --device cpu as two processes on the
  tiny fixture (torchrun's four variables, a port found free just
  before): darwin.0.out and darwin.1.out, a --merged-out byte-identical
  on both ranks, to darwin.0.out and darwin.1.out's sorted-unique union,
  to the fixture's out.darwin sorted-unique and to darwin_tpu's
  single-process --merged-out; the seed table built by rank 0.
Every spawned process has a timeout, so a hung rendezvous fails one test.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from darwin_tpu import cli as jax_cli
from darwin_tpu.parallel import distributed as jax_dist
from darwin_tpu_torch.parallel import distributed as dist

REPO = Path(__file__).resolve().parent.parent


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # two processes share the test worker
    env.update(extra)
    return env


def _run_all(procs, timeout=120):
    """Wait for every process (killing all at the first timeout); returns
    their (returncode, stdout, stderr)."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("num_reads,count",
                         [(40, 1), (40, 4), (41, 4), (3, 8), (0, 4), (7, 3)])
def test_read_range_equals_jax(num_reads, count):
    ranges = [dist.read_range(num_reads, i, count) for i in range(count)]
    assert ranges == [jax_dist.read_range(num_reads, i, count)
                      for i in range(count)]
    assert [k for r in ranges for k in r] == list(range(num_reads))


def test_single_process_paths(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert dist.maybe_initialize() is False
    assert dist.process_count() == 1 and dist.process_index() == 0
    assert list(dist.read_range(7)) == list(range(7))
    recs = ["b x", "a y", "b x", "c"]
    assert dist.allgather_records(recs) == ["a y", "b x", "c"] == \
        jax_dist.allgather_records(recs)
    assert dist.allgather_records([]) == []
    dist.barrier("test")
    dist.shutdown()


_GATHER = """
import json, sys
from darwin_tpu_torch.parallel import distributed as dist
rank = int(sys.argv[2])
assert dist.maybe_initialize("file://" + sys.argv[1], 2, rank) is True
assert (dist.process_count(), dist.process_index()) == (2, rank)
mine = {0: ["r1 b", "r0 a", "r1 b", "x" * 5000], 1: []}[rank]
first = dist.allgather_records(mine)
second = dist.allgather_records(["r0 a", "z \\u00e9"] if rank else ["q"])
dist.barrier()
print(json.dumps([first, second]))
dist.shutdown()
assert not dist.maybe_initialize() and dist.process_count() == 1
"""


def test_allgather_records_two_gloo_processes(tmp_path):
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GATHER, str(tmp_path / "pg"), str(r)],
        env=_env(), cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    res = _run_all(procs)
    for rc, _, err in res:
        assert rc == 0, err[-2000:]
    outs = [r[1].strip().splitlines()[-1] for r in res]
    assert outs[0] == outs[1]
    import json
    first, second = json.loads(outs[0])
    assert first == ["r0 a", "r1 b", "x" * 5000]
    assert second == ["q", "r0 a", "z é"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_distributed_two_processes(data_dir, tmp_path):
    d = data_dir / "tiny"
    common = [str(d / "reads.fasta"), str(d / "reads.fasta"), "--params",
              str(d / "params.cfg"), "--batch-size", "64"]
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "darwin_tpu_torch.cli", *common,
         "--device", "cpu", "--distributed", "--out-dir", str(tmp_path),
         "--seed-table", str(tmp_path / "table.npz"), "--merged-out",
         str(tmp_path / f"merged.{r}")],
        env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE="2",
                 RANK=str(r)),
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    res = _run_all(procs)
    for rc, _, err in res:
        assert rc == 0, err[-2000:]
    assert "reads [0, 4)" in res[0][1] and "reads [4, 8)" in res[1][1]
    assert all("coordinator-built" in r[1] for r in res)
    m0 = (tmp_path / "merged.0").read_bytes()
    assert m0 == (tmp_path / "merged.1").read_bytes()
    lines = [ln for r in range(2) for ln in
             (tmp_path / f"darwin.{r}.out").read_text().splitlines()]
    union = "".join(ln + "\n" for ln in sorted(set(lines)))
    want = sorted(set((d / "out.darwin").read_text().splitlines()))
    assert m0.decode() == union == "".join(ln + "\n" for ln in want)
    jout = tmp_path / "jax"
    assert jax_cli.main([*common, "--engine", "host", "--backend", "lax",
                         "--out-dir", str(jout), "--merged-out",
                         str(jout / "merged")]) == 0
    assert (jout / "merged").read_bytes() == m0
