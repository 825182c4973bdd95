"""darwin_tpu_torch CLI against darwin_tpu's CLI on the tiny fixture.

* with the same engine order (darwin_tpu's device engine, lax backend),
  the port (--device cpu) writes byte-identical darwin.<i>.out and
  --merged-out files;
* a seed table saved by darwin_tpu.cli --seed-table loads into the port
  and gives the same records;
* in a fresh interpreter, importing the port and running tiny end to
  end never imports jax.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from darwin_tpu import cli as jax_cli
from darwin_tpu_torch import cli
from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _args(d, out, *extra):
    return [str(d / "reads.fasta"), str(d / "reads.fasta"), "2",
            "--params", str(d / "params.cfg"), "--batch-size", "64",
            "--out-dir", str(out), "--merged-out", str(out / "merged"),
            *extra]


@pytest.fixture(scope="module")
def jax_run(data_dir, tmp_path_factory):
    """darwin_tpu.cli on tiny with its device engine; saves the table."""
    d = data_dir / "tiny"
    out = tmp_path_factory.mktemp("jax_cli")
    table = out / "table.npz"
    assert jax_cli.main(_args(d, out, "--engine", "device", "--backend",
                              "lax", "--seed-table", str(table))) == 0
    return d, out, table


def test_cli_files_match_jax_cli(jax_run, tmp_path):
    d, jout, _ = jax_run
    assert cli.main(_args(d, tmp_path, "--device", "cpu")) == 0
    for name in ("darwin.0.out", "darwin.1.out", "merged"):
        assert (tmp_path / name).read_bytes() == (jout / name).read_bytes(), \
            name
    merged = (tmp_path / "merged").read_text().splitlines()
    assert merged == sorted(set((d / "out.darwin").read_text()
                                .splitlines()))


def test_cli_loads_jax_seed_table(jax_run, tmp_path, capsys):
    d, jout, table = jax_run
    assert cli.main(_args(d, tmp_path, "--device", "cpu", "--seed-table",
                          str(table))) == 0
    assert f"Seed table loaded from {table}" in capsys.readouterr().out
    assert (tmp_path / "merged").read_bytes() == \
        (jout / "merged").read_bytes()


def test_cli_rejects_missing_cuda(data_dir, tmp_path, monkeypatch):
    """--device cuda without a card fails; it never falls back."""
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: False)
    assert cli.main(_args(data_dir / "tiny", tmp_path)) == 2
    assert not (tmp_path / "merged").exists()


def test_port_runs_tiny_without_jax(data_dir, tmp_path):
    d = data_dir / "tiny"
    script = (
        "import json, sys\n"
        "from darwin_tpu_torch import cli\n"
        f"rc = cli.main({_args(d, tmp_path, '--device', 'cpu')!r})\n"
        "print(json.dumps({'rc': rc, 'jax': 'jax' in sys.modules}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {
        "rc": 0, "jax": False}
    assert (tmp_path / "merged").read_text().splitlines() == sorted(
        set((d / "out.darwin").read_text().splitlines()))
