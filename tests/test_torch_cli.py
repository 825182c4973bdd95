"""darwin_tpu_torch CLI against darwin_tpu's CLI on the tiny fixture.

* with the same engine (darwin_tpu's device engine or its host engine,
  lax backend), the port (--device cpu) writes byte-identical
  darwin.<i>.out, --merged-out, --paf-out and darwin.<i>.paf files;
* --resume takes the ranges the JAX CLI wrote (.out and .paf sidecar),
  prints the JAX CLI's "resumed" lines, writes the same files, and
  builds no banks or engine when every range is resumed;
* --chunk-reads 7 on the guided fixture (separate reference; at tile
  64, to keep the CPU run short) writes the JAX CLI's files; in self
  mode it is ignored with the JAX CLI's message;
* a seed table saved by darwin_tpu.cli --seed-table loads into the port
  and gives the same records;
* in a fresh interpreter, importing the port and running tiny end to
  end on both engines never imports jax;
* --metrics-json writes every key darwin_tpu.cli writes (but the
  XLA-only engine_compiles), with the same counts.
"""

import json
import os
import re
import shutil
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
                              "lax", "--seed-table", str(table),
                              "--paf-out", str(out / "paf"),
                              "--metrics-json",
                              str(out / "metrics.json"))) == 0
    return d, out, table


@pytest.fixture(scope="module")
def jax_host_run(data_dir, tmp_path_factory):
    """darwin_tpu.cli on tiny with its host engine, with --paf-out."""
    d = data_dir / "tiny"
    out = tmp_path_factory.mktemp("jax_cli_host")
    assert jax_cli.main(_args(d, out, "--engine", "host", "--backend", "lax",
                              "--paf-out", str(out / "paf"))) == 0
    return d, out


FILES = ("darwin.0.out", "darwin.1.out", "merged", "darwin.0.paf",
         "darwin.1.paf", "paf")


def _same_files(got: Path, want: Path, names=FILES):
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


def test_cli_files_match_jax_cli(jax_run, tmp_path):
    d, jout, _ = jax_run
    assert cli.main(_args(d, tmp_path, "--device", "cpu", "--paf-out",
                          str(tmp_path / "paf"), "--metrics-json",
                          str(tmp_path / "metrics.json"))) == 0
    _same_files(tmp_path, jout)
    got = json.loads((tmp_path / "metrics.json").read_text())
    want = json.loads((jout / "metrics.json").read_text())
    want.pop("engine_compiles")
    assert want.keys() <= got.keys(), sorted(want.keys() - got.keys())
    for k in ("batch_size", "ref_length", "num_reads", "num_candidates",
              "num_records", "engine", "dsoft"):
        assert got[k] == want[k], k
    assert got["seed_ms"] == pytest.approx(got["seed_s"] * 1e3)
    assert got["gact_ms"] == pytest.approx(got["align_s"] * 1e3)
    assert got["seed_table_ms"] == pytest.approx(got["seed_table_s"] * 1e3)
    merged = (tmp_path / "merged").read_text().splitlines()
    assert merged == sorted(set((d / "out.darwin").read_text()
                                .splitlines()))


def test_cli_host_engine_and_paf_match_jax_cli(jax_host_run, tmp_path):
    d, jout = jax_host_run
    assert cli.main(_args(d, tmp_path, "--device", "cpu", "--engine", "host",
                          "--paf-out", str(tmp_path / "paf"))) == 0
    _same_files(tmp_path, jout)
    assert (tmp_path / "merged").read_text().splitlines() == sorted(
        set((d / "out.darwin").read_text().splitlines()))
    assert len((tmp_path / "paf").read_text().splitlines()) > 0


def _resumed_lines(out: str, od: Path) -> list[str]:
    return [ln.replace(str(od), "OUT") for ln in out.splitlines()
            if "resumed" in ln]


def test_cli_resume_from_jax_outputs(jax_host_run, tmp_path, capsys,
                                     monkeypatch):
    """Both CLIs resume range 0 from the JAX run's darwin.0.out/.paf and
    compute range 1; then the port resumes every range without
    building banks or an engine."""
    d, jout = jax_host_run
    got = {}
    for tool, main, extra in (
            ("jax", jax_cli.main, ["--backend", "lax"]),
            ("port", cli.main, ["--device", "cpu"])):
        od = tmp_path / tool
        od.mkdir()
        for name in ("darwin.0.out", "darwin.0.paf"):
            shutil.copy(jout / name, od / name)
        capsys.readouterr()
        assert main(_args(d, od, "--engine", "host", "--resume",
                          "--paf-out", str(od / "paf"), *extra)) == 0
        got[tool] = _resumed_lines(capsys.readouterr().out, od)
    assert got["port"] == got["jax"] and len(got["port"]) == 1
    assert re.fullmatch(r"range 0: resumed from OUT/darwin.0.out "
                        r"\(\d+ records\)", got["port"][0])
    _same_files(tmp_path / "port", jout)

    def no_build(*a, **k):
        raise AssertionError("built banks or an engine")

    monkeypatch.setattr(cli, "make_merged_engine", no_build)
    monkeypatch.setattr(cli, "read_banks", no_build)
    od = tmp_path / "port"
    (od / "paf").unlink()
    assert cli.main(_args(d, od, "--device", "cpu", "--resume",
                          "--paf-out", str(od / "paf"))) == 0
    assert len(_resumed_lines(capsys.readouterr().out, od)) == 2
    _same_files(od, jout)


def test_cli_chunk_reads_matches_jax_cli(data_dir, tmp_path, capsys,
                                         jax_run):
    d = data_dir / "guided"
    params = tmp_path / "params.cfg"
    params.write_text((d / "params.cfg").read_text()
                      .replace("tile_size = 320", "tile_size = 64")
                      .replace("tile_overlap = 120", "tile_overlap = 24"))
    args = [str(d / "ref.fasta"), str(d / "reads.fasta"), "--params",
            str(params), "--batch-size", "64", "--chunk-reads", "7"]
    jout, pout = tmp_path / "jax", tmp_path / "port"
    assert jax_cli.main(args + ["--out-dir", str(jout), "--merged-out",
                                str(jout / "merged"), "--engine", "device",
                                "--backend", "lax"]) == 0
    assert cli.main(args + ["--out-dir", str(pout), "--merged-out",
                            str(pout / "merged"), "--device", "cpu"]) == 0
    assert "chunk 2: 4 reads" in capsys.readouterr().out
    _same_files(pout, jout, ("darwin.0.out", "darwin.1.out",
                             "darwin.2.out", "merged"))
    assert len((pout / "merged").read_text().splitlines()) == 18

    tiny, tout, _ = jax_run
    assert cli.main(_args(tiny, tmp_path / "self", "--device", "cpu",
                          "--chunk-reads", "3")) == 0
    assert ("--chunk-reads ignored: self-overlap mode needs the whole read "
            "set in memory") in capsys.readouterr().out
    _same_files(tmp_path / "self", tout, ("darwin.0.out", "darwin.1.out",
                                          "merged"))


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
    """Both engines, --paf-out, and the score evaluator's module, in a
    fresh interpreter."""
    d = data_dir / "tiny"
    host = tmp_path / "host"
    host_args = _args(d, host, "--device", "cpu", "--engine", "host",
                      "--paf-out", str(host / "paf"))
    script = (
        "import json, sys\n"
        "from darwin_tpu_torch import cli\n"
        "import darwin_tpu_torch.eval.score_eval\n"
        f"rc = cli.main({_args(d, tmp_path, '--device', 'cpu')!r})\n"
        f"rc += cli.main({host_args!r})\n"
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
    for od in (tmp_path, host):
        assert (od / "merged").read_text().splitlines() == sorted(
            set((d / "out.darwin").read_text().splitlines()))
    assert (host / "paf").stat().st_size > 0
