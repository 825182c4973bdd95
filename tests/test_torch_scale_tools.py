"""The port's scale and serving tools (tools/torch_*.py) on the CPU, at
tiny scales: the smokes of tests/test_tools.py on the port, plus

* the port's guided multi-chromosome record set, set-equal to the JAX
  package's own tools/scale_test.py on the same flags, and its dataset
  byte-identical to that tool's;
* tests/data/guided_shape/'s digest, regenerated with the port's
  generator (marked slow: about 30 s);
* torch_scale_test --expect exiting 1 on a record file with one line
  removed.

Each tool runs in this process with --device cpu (the kernels' plain
versions); tools that align take the tiny fixture's params (T = 64)
where a test can pass them, to keep the file's time down.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke
from darwin_tpu_torch.config import Params
from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY = REPO / "tests" / "data" / "tiny" / "params.cfg"
GUIDED_SHAPE = REPO / "tests" / "data" / "guided_shape"
# A guided dataset in three pieces, small enough for the plain versions.
GUIDED_FLAGS = ["--guided", "--chromosomes", "3", "--genome", "15000",
                "--reads", "6", "--read-len", "1200", "--error", "0.05",
                "--params", str(TINY), "--batch-size", "32"]

sys.path.insert(0, str(REPO / "tools"))
import torch_bigcoord_dryrun as bigcoord  # noqa: E402
import torch_mem_usage as mem_usage  # noqa: E402
import torch_resident_serve as resident  # noqa: E402
import torch_scale_test as scale_test  # noqa: E402
import torch_sharded_scale as sharded_scale  # noqa: E402


def _port(capsys, *flags, workdir):
    rc = scale_test.main([*flags, "--device", "cpu", "--warm", "0",
                          "--workdir", str(workdir)])
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_guided(tmp_path_factory):
    """The JAX package's tools/scale_test.py (unedited) on GUIDED_FLAGS,
    on the CPU: its workdir."""
    work = tmp_path_factory.mktemp("jax_scale_test")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO), os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, str(REPO / "tools/scale_test.py"),
                        *GUIDED_FLAGS, "--workdir", str(work)],
                       capture_output=True, text=True, env=env, cwd=work,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "skipping differential" in r.stdout
    return work


def test_scale_test_de_novo_runs_without_expect(tmp_path, capsys):
    rc, out = _port(capsys, "--genome", "8000", "--reads", "8",
                    "--read-len", "1500", "--error", "0.05", "--params",
                    str(TINY), "--batch-size", "32", workdir=tmp_path)
    assert rc == 0, out
    assert "skipping differential" in out
    assert "sensitivity " in out and "peak RSS" in out
    assert (tmp_path / "ours.darwin").read_text().strip()


@pytest.mark.parametrize("engine,dsoft", [("device", "host"),
                                          ("host", "host"),
                                          ("device", "device")])
def test_scale_test_guided_chromosomes_equal_the_jax_tool(
        tmp_path, capsys, jax_guided, engine, dsoft):
    """Same flags, byte-identical FASTA files, and the JAX tool's
    ours.darwin as --expect: PARITY: EXACT under each engine and
    D-SOFT."""
    rc, out = _port(capsys, *GUIDED_FLAGS, "--engine", engine, "--dsoft",
                    dsoft, "--expect", str(jax_guided / "ours.darwin"),
                    workdir=tmp_path)
    for f in ("genome.fasta", "reads.fasta"):
        assert (tmp_path / f).read_bytes() == (jax_guided / f).read_bytes()
    n = len((jax_guided / "ours.darwin").read_text().splitlines())
    assert rc == 0 and f"PARITY: EXACT ({n} records)" in out, out
    assert n >= 3 and "+/-50 bp" in out


def test_scale_test_expect_with_a_line_removed_exits_1(
        tmp_path, capsys, jax_guided):
    lines = (jax_guided / "ours.darwin").read_text().splitlines()
    short = tmp_path / "short.darwin"
    short.write_text("".join(x + "\n" for x in lines[1:]))
    rc, out = _port(capsys, *GUIDED_FLAGS, "--expect", str(short),
                    workdir=tmp_path / "w")
    assert rc == 1
    assert "PARITY: FAILED missing=0 extra=1" in out, out


def test_scale_test_guided_sensitivity_by_chromosome():
    """Read ids restart in each chromosome: each read is scored against
    its own chromosome's reads."""
    names = ["c0R0_100_1000", "c1R0_500_1000", "c1R1_900_1000"]
    fmt = ("ref_id: chr{c}, query_id: {q}, ab: {ab}, ae: {ae}, bb: 0, "
           "be: 1000, score: 900, comp: 0")
    recs = [fmt.format(c=0, q=names[0], ab=100, ae=1100),
            fmt.format(c=1, q=names[1], ab=5000, ae=6000)]
    ev = scale_test.sensitivity(recs, names, guided=True)
    assert (ev.tp, ev.fp, ev.fn) == (1, 1, 1)


@pytest.mark.slow
def test_guided_shape_digest_from_the_port_generator(tmp_path):
    """tests/data/guided_shape's dataset, rebuilt by
    torch_scale_test.make_dataset from chip_smoke's GUIDED_SHAPE_FLAGS
    (the flags of the JAX tool's command in its README), has the
    recorded digests.  Slow: the generator's per-event loop over 4600
    reads takes about 30 s on one core; chip_smoke.py's phase 11 checks
    the same digests on every card run."""
    flags = " ".join(chip_smoke.GUIDED_SHAPE_FLAGS)
    readme = (GUIDED_SHAPE / "README").read_text().replace("\\\n", " ")
    assert f"tools/scale_test.py {flags} --workdir" in " ".join(
        readme.split())
    scale_test.make_dataset(
        scale_test.parse_args(list(chip_smoke.GUIDED_SHAPE_FLAGS)), tmp_path)
    got = {f: hashlib.sha256((tmp_path / f).read_bytes()).hexdigest()
           for f in ("genome.fasta", "reads.fasta")}
    assert got == chip_smoke.guided_shape_digests()


def test_mem_usage_device_mode_without_a_card(capsys):
    assert mem_usage.main(["device"]) == 0
    assert "no CUDA device" in capsys.readouterr().out
    self_gb, _ = mem_usage.peak_rss_gb()
    assert self_gb > 0 and mem_usage.peak_device_gb("cpu") is None
    assert "total" in mem_usage.host_memory_line()


@pytest.mark.parametrize("engine,dsoft,filler", [
    ("host", "host", None), ("host", "device", None),
    ("device", "host", None), ("device", "device", None),
    ("device", "device", "N")])
def test_bigcoord_dryrun_smoke(capsys, engine, dsoft, filler):
    args = bigcoord.parse_args(
        ["--gb", "0.002", "--pieces", "3" if filler else "2", "--reads",
         "2", "--read-len", "1500", "--engine", engine, "--dsoft", dsoft,
         "--device", "cpu"] + (["--filler", filler] if filler else []))
    assert bigcoord.run(args, Params.from_cfg(str(TINY))) == 0
    out = capsys.readouterr().out
    assert "BIGCOORD DRYRUN OK" in out and out.count("remapped=True") == 2


def test_bigcoord_filler_keeps_the_coordinates():
    """--filler N: the same pieces and bins, every piece but the last all
    N, the last piece the random one."""
    argv = ["--gb", "0.001", "--pieces", "3", "--reads", "1",
            "--read-len", "1000", "--device", "cpu"]
    params = Params.from_cfg(str(TINY))
    plain = bigcoord.build(bigcoord.parse_args(argv), params, log=len)
    fill = bigcoord.build(bigcoord.parse_args(argv + ["--filler", "N"]),
                          params, log=len)
    assert (fill["genome"].chr_id_to_start_bin.tolist()
            == plain["genome"].chr_id_to_start_bin.tolist())
    assert {c for p in fill["pieces"][:-1] for c in set(p.seq)} == {"N"}
    assert set(fill["pieces"][-1].seq) == set("ACGT")
    assert int(fill["table"].pos.max()) >= int(
        fill["genome"].chr_id_to_start_bin[-1]) * params.bin_size


@pytest.mark.parametrize("dsoft", ["host", "device"])
def test_resident_serve_batches_equal_the_one_shot_run(dsoft):
    ref, reads = resident.dataset(50_000, 2, read_len=1500)
    assert [r.name for r in ref] == ["chr0"]
    assert resident.check(ref, reads, Params.from_cfg(str(TINY)), reps=2,
                          device="cpu", dsoft=dsoft, log=len) == 0


def test_sharded_scale_on_eight_cpu_entries(tmp_path, capsys):
    out_json = tmp_path / "out.json"
    assert sharded_scale.main(["--genome", "200000", "--reads", "8",
                               "--read-len", "2000", "--device", "cpu",
                               "--json", str(out_json)]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("PARITY: EXACT")
    import json

    got = json.loads(out_json.read_text())
    assert got["entries"] == 8 and got["ok"]
    assert set(got["results"]) == {"all_gather", "all_to_all"}


def test_tools_refuse_cuda_without_a_card(tmp_path):
    """--device cuda (the default) raises where no card is visible."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale_test.main(["--genome", "20000", "--reads", "2",
                         "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resident.main(["2e4", "2", "1"])
