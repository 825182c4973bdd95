"""The port's own build of the native host library, against darwin_tpu.

darwin_tpu_torch.native compiles its copy of darwin_tpu/native/src/
dtnative.cpp (darwin_tpu_torch/native_src/) into darwin_tpu_torch/
_build/ under a name keyed on the flags, the source and the host CPU.
Its entry points must equal darwin_tpu.native and the NumPy fallbacks on
tests/data/tiny, and the port's host stages (FASTA, seed table, D-SOFT)
must give the same result with the library and without it.  Every output
is an integer or a string: the comparisons are exact.
"""

import json

import numpy as np
import pytest

from darwin_tpu import native as jax_native
from darwin_tpu.index.seed_table import SeedTable as JaxSeedTable
from darwin_tpu_torch import cli, native, pipeline
from darwin_tpu_torch.coding import ref_minimizers, seq_to_bytes
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.dsoft import dsoft
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import parse_fasta
from tests._torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny(data_dir):
    d = data_dir / "tiny"
    params = Params.from_cfg(d / "params.cfg")
    reads = parse_fasta(d / "reads.fasta", native=False)
    genome = Genome(reads, params.bin_size)
    return d, params, reads, genome


def test_port_library_builds_and_loads():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.SRC.read_bytes() == (
        native.SRC.parents[2] / "darwin_tpu" / "native" / "src"
        / "dtnative.cpp").read_bytes()
    assert "-fopenmp" not in native.CXX_FLAGS
    assert "-pthread" in native.CXX_FLAGS


def test_stress_program_passes_on_the_ports_build(tmp_path):
    """The native library's stress program (tools/torch_native_stress.py),
    built with the port's -pthread flags, finds every thread count's
    table build and D-SOFT batch the same."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_native_stress.py"
    spec = importlib.util.spec_from_file_location("torch_native_stress",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert "-pthread" in tool.flags() and "-fopenmp" not in tool.flags()
    exe, err = tool.build(tmp_path)
    assert err is None, err
    r = tool.run(exe, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "STRESS OK" in r.stdout
    assert r.stdout.count("deterministic") == 4


def test_library_key_follows_cpu_line_and_rebuilds(tmp_path):
    """Another CPU model line names another library, which is built
    anew; an existing library is not rebuilt."""
    here = native.library_path(build_dir=tmp_path)
    other = native.library_path(cpu="another CPU", build_dir=tmp_path)
    assert here != other
    assert here == native.library_path(cpu=native.cpu_line(),
                                       build_dir=tmp_path)
    assert native.build(other) is None
    assert other.exists() and not here.exists()
    stamp = other.stat().st_mtime_ns
    assert native.build(other) is None
    assert other.stat().st_mtime_ns == stamp
    assert native.build(here) is None
    assert here.exists()


def test_build_failure_returns_compiler_error(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ["--no-such-flag"])
    err = native.build(native.library_path(build_dir=tmp_path))
    assert err and "no-such-flag" in err


def test_build_table_keys_matches_fallback_and_reference(tiny):
    _, params, _, genome = tiny
    ref = genome.concat
    for k, w in [(params.seed_size, params.window_size), (12, 3), (5, 2)]:
        got = native.build_table_keys(ref, k, w, num_threads=3)
        np.testing.assert_array_equal(got, np.sort(ref_minimizers(ref, k, w)))
        np.testing.assert_array_equal(
            got, jax_native.build_table_keys(ref, k, w, num_threads=3))


@pytest.mark.parametrize("with_native", [True, False])
def test_seed_table_matches_reference_build(tiny, monkeypatch, with_native):
    """Both paths of the port's SeedTable.build equal darwin_tpu's,
    including the drop of padding positions when k + w < 16."""
    _, params, _, genome = tiny
    if not with_native:
        monkeypatch.setattr(native, "available", lambda: False)
    for k, w in [(params.seed_size, params.window_size), (5, 2)]:
        got = SeedTable.build(genome.concat, k, 32, params.bin_size, w)
        want = JaxSeedTable.build(genome.concat, k, 32, params.bin_size, w)
        np.testing.assert_array_equal(got.hashes, want.hashes)
        np.testing.assert_array_equal(got.pos, want.pos)
        assert (got.k, got.w, got.bin_size, got.ref_size,
                got.kmer_max_occurence) == (
            want.k, want.w, want.bin_size, want.ref_size,
            want.kmer_max_occurence)
        assert (got.pos < got.ref_size).all()


def test_dsoft_batch_matches_fallback_and_reference(tiny):
    _, params, reads, genome = tiny
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size)
    bank = SeqBank([seq_to_bytes(r.seq) for r in reads])
    ids = np.arange(len(reads), dtype=np.int64)
    args = (table.hashes, table.pos, table.k, table.w, table.bin_size,
            table.ref_size, table.kmer_max_occurence, bank.flat,
            bank.starts, bank.lengths, ids, params.num_seeds,
            params.threshold, params.max_candidates)
    counts, hits, offs = native.dsoft_batch(*args, num_threads=2)
    for a, b in zip((counts, hits, offs),
                    jax_native.dsoft_batch(*args, num_threads=2)):
        np.testing.assert_array_equal(a, b)
    assert counts.sum() > 0
    at = 0
    for k in range(len(reads)):
        vhits, voffs = dsoft(table, bank.slice(k, 0, int(bank.lengths[k])),
                             params.num_seeds, params.threshold,
                             params.max_candidates)
        np.testing.assert_array_equal(hits[at:at + counts[k]], vhits)
        np.testing.assert_array_equal(offs[at:at + counts[k]], voffs)
        at += counts[k]
    assert at == len(hits)


def test_collect_calls_same_with_and_without_library(tiny, monkeypatch):
    _, params, reads, genome = tiny
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    bank = SeqBank.concat(*pipeline.read_banks(reads))
    nat = pipeline.collect_calls(table, genome, bank, params)
    monkeypatch.setattr(native, "available", lambda: False)
    py = pipeline.collect_calls(table, genome, bank, params)
    assert len(nat.ref_id) > 0
    for f in ("ref_id", "query_id", "ref_pos", "query_pos"):
        np.testing.assert_array_equal(getattr(nat, f), getattr(py, f))


def test_parse_fasta_matches_pure_and_reference(tiny, tmp_path):
    d, _, reads, _ = tiny
    path = d / "reads.fasta"
    got = [(r.fields, r.seq) for r in native.parse_fasta(path)]
    assert got == [(r.fields, r.seq) for r in reads]
    assert got == [(r.fields, r.seq) for r in jax_native.parse_fasta(path)]
    bad = tmp_path / "bad.fasta"
    bad.write_text("ACGT\n>r1\nAC\n")
    assert native.parse_fasta(bad) is None
    with pytest.raises(ValueError):
        parse_fasta(bad)  # the pure parser's error


@pytest.mark.parametrize("with_native", [True, False])
def test_cli_records_host_native(tiny, tmp_path, monkeypatch, with_native):
    """--metrics-json says whether the host stages ran natively; the
    records do not depend on it."""
    d = tiny[0]
    if not with_native:
        monkeypatch.setattr(native, "available", lambda: False)
    m = tmp_path / "m.json"
    assert cli.main([str(d / "reads.fasta"), str(d / "reads.fasta"),
                     "--params", str(d / "params.cfg"), "--batch-size",
                     "64", "--out-dir", str(tmp_path), "--merged-out",
                     str(tmp_path / "merged"), "--metrics-json", str(m),
                     "--device", "cpu"]) == 0
    assert json.loads(m.read_text())["host_native"] is with_native
    assert (tmp_path / "merged").read_text().splitlines() == sorted(
        set((d / "out.darwin").read_text().splitlines()))
