"""darwin_tpu_torch stands alone: it imports nothing of darwin_tpu and
never jax, and its copies of darwin_tpu's host modules (config, coding,
io.fasta, index, dsoft, format_record, eval helpers and datagen) give
darwin_tpu's results on every fixture, as do the mesh and multi-host
layers' (read_range, balance_calls, and the table-sharded D-SOFT's
shard_bounds, make_sharded_table, make_sharded_dense_index and
derive_budgets); tools/torch_fuzz_soak.py's copies of
tests/test_fuzz_pipeline.py's instance generators give its instances.  (The copies of golden/, eval/sensitivity.py and
dsoft/device.py's host helpers are held to theirs in
test_torch_golden.py, test_torch_sensitivity.py and
test_torch_dsoft_device.py.)  Every output is an integer, a string or a
byte: the comparisons are exact."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from darwin_tpu import config as jax_config
from darwin_tpu import utils as jax_utils
from darwin_tpu.coding import ntcoding as jax_coding
from darwin_tpu.dsoft import filter as jax_filter
from darwin_tpu.dsoft import sharded_table as jax_sharded
from darwin_tpu.engine import device_batch as jax_device_batch
from darwin_tpu.eval import datagen as jax_datagen
from darwin_tpu.eval import score_eval as jax_score_eval
from darwin_tpu.golden.gact import format_record as jax_format_record
from darwin_tpu.index.genome import Genome as JaxGenome
from darwin_tpu.index.seed_table import SeedTable as JaxSeedTable
from darwin_tpu.io import fasta as jax_fasta
from darwin_tpu.parallel import distributed as jax_distributed
from darwin_tpu_torch import coding, config, native, utils
from darwin_tpu_torch.dsoft import filter as dsoft_filter
from darwin_tpu_torch.dsoft import sharded_table
from darwin_tpu_torch.engine import device_batch
from darwin_tpu_torch.parallel import distributed
from darwin_tpu_torch.golden.gact import format_record
from darwin_tpu_torch.eval import datagen, score_eval
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io import fasta

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
FIXTURES = sorted(p.parent.name for p in DATA.glob("*/params.cfg"))


def _fixture(name):
    """(port Params, jax Params, port read records, jax read records)."""
    d = DATA / name
    return (config.Params.from_cfg(d / "params.cfg"),
            jax_config.Params.from_cfg(d / "params.cfg"),
            fasta.parse_fasta(d / "reads.fasta", native=False),
            jax_fasta.parse_fasta(d / "reads.fasta", native=False))


def _imports_darwin_tpu(path: Path) -> list[str]:
    """The darwin_tpu modules a source file imports."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        bad += [n for n in names
                if n == "darwin_tpu" or n.startswith("darwin_tpu.")]
    return bad


PORT_TOOLS = ("torch_profile_ecoli.py", "torch_fuzz_soak.py",
              "torch_dsoft_phases.py", "torch_mesh_engine.py",
              "torch_bench_e2e.py", "torch_drain_prof.py",
              "torch_native_stress.py", "torch_mem_usage.py",
              "torch_scale_test.py", "torch_resident_serve.py",
              "torch_bigcoord_dryrun.py", "torch_sharded_scale.py",
              "torch_tile_geom.py", "torch_profile.py",
              "torch_engine_prof.py", "torch_geom_e2e_ab.py",
              "torch_scaling_run.py")


def _tool(name: str):
    """tools/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["dsoft.cu", "dsoft_sharded.cu"])
def test_phase_tool_patches_the_kernels_it_times(sharded):
    """tools/torch_dsoft_phases.py's stamps each find their place in the
    kernel source they instrument, once (the tool raises otherwise, and
    runs only on a card)."""
    tool = _tool("torch_dsoft_phases")
    csrc = REPO / "darwin_tpu_torch" / "csrc"
    if sharded:
        out = tool.instrument((csrc / "dsoft_sharded.cu").read_text(),
                              tool.SHARDED_PATCHES, tool.SHARDED_READER)
        assert out.count("PH(") == len(tool.SHARDED_PHASES) + 1
    else:
        out = tool.instrument((csrc / "dsoft.cu").read_text())
        assert out.count("STAMP(") == 9


def test_stress_source_is_the_references():
    """native_src/stress_main.cpp, which tools/torch_native_stress.py
    builds, is darwin_tpu/native/src/stress_main.cpp byte for byte."""
    assert (REPO / "darwin_tpu_torch" / "native_src" / "stress_main.cpp"
            ).read_bytes() == (REPO / "darwin_tpu" / "native" / "src"
                               / "stress_main.cpp").read_bytes()


def test_no_source_of_the_port_imports_darwin_tpu():
    files = [*sorted((REPO / "darwin_tpu_torch").rglob("*.py")),
             REPO / "chip_smoke.py",
             *(REPO / "tools" / t for t in PORT_TOOLS)]
    bad = {str(f.relative_to(REPO)): _imports_darwin_tpu(f) for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_importing_the_port_loads_no_jax_and_no_darwin_tpu():
    """A fresh interpreter imports every module of darwin_tpu_torch,
    chip_smoke and the port's tools; none of them loads jax or a
    darwin_tpu module (the modules loaded before the imports, by the
    interpreter's own start-up, are not counted)."""
    code = """
import importlib, importlib.util, pkgutil, sys
before = set(sys.modules)
sys.path.insert(0, sys.argv[1])
import darwin_tpu_torch
names = [m.name for m in pkgutil.walk_packages(darwin_tpu_torch.__path__,
                                               "darwin_tpu_torch.")]
missing = set(sys.argv[2].split(",")) - set(names)
assert not missing, missing
for n in names:
    importlib.import_module(n)
import chip_smoke
for tool in sys.argv[3].split(","):
    spec = importlib.util.spec_from_file_location(
        tool, sys.argv[1] + "/tools/" + tool + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "darwin_tpu"))
print(len(names), bad)
"""
    # The mesh and multi-host layers, entry.py and bench.py among them.
    layers = ",".join(f"darwin_tpu_torch.{m}" for m in (
        "parallel.mesh", "parallel.collectives", "parallel.distributed",
        "dsoft.sharded_table", "entry", "bench"))
    tools = ",".join(t[:-3] for t in PORT_TOOLS)
    out = subprocess.run([sys.executable, "-c", code, str(REPO), layers,
                          tools], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 30 and bad.strip() == "[]", out.stdout


@pytest.mark.parametrize("name", FIXTURES)
def test_params_from_cfg_field_for_field(name):
    got, want, *_ = _fixture(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.early_terminate == want.early_terminate


@pytest.mark.parametrize("name", FIXTURES)
def test_parse_fasta_native_and_pure_equal_jax(name):
    for f in sorted((DATA / name).glob("*.fasta")):
        want = [(r.fields, r.seq) for r in jax_fasta.parse_fasta(
            f, native=False)]
        assert [(r.fields, r.seq) for r in fasta.parse_fasta(f)] == want
        assert [(r.fields, r.seq)
                for r in fasta.parse_fasta(f, native=False)] == want
        assert [(r.fields, r.seq) for r in fasta.iter_fasta(f)] == want


@pytest.mark.parametrize("name", FIXTURES)
def test_check_reference_wrap_equals_jax(name, tmp_path):
    """The fixture's FASTA files, and copies rewrapped at 60, 70 and 80
    columns (a short line before a long one, a line past 70), both
    with CRLF line ends."""
    files = sorted((DATA / name).glob("*.fasta"))
    reads = fasta.parse_fasta(files[0], native=False)[:5]
    for wrap in (60, 70, 80):
        f = tmp_path / f"w{wrap}.fasta"
        fasta.write_fasta(f, [(r.name, r.seq) for r in reads], wrap=wrap)
        crlf = tmp_path / f"w{wrap}_crlf.fasta"
        crlf.write_bytes(f.read_bytes().replace(b"\n", b"\r\n"))
        files += [f, crlf]
    results = [fasta.check_reference_wrap(f) for f in files]
    assert results == [jax_fasta.check_reference_wrap(f) for f in files]
    assert results[-6:] == [False, False, True, True, False, False]


@pytest.mark.parametrize("name", FIXTURES)
def test_minimizers_and_bytes_equal_jax(name):
    params, _, reads, _ = _fixture(name)
    k, w = params.seed_size, params.window_size
    for r in reads[:8]:
        b = coding.seq_to_bytes(r.seq)
        np.testing.assert_array_equal(b, jax_coding.seq_to_bytes(r.seq))
        np.testing.assert_array_equal(coding.ref_minimizers(r.seq, k, w),
                                      jax_coding.ref_minimizers(r.seq, k, w))
        for got, want in zip(coding.query_minimizers(b, k, w),
                             jax_coding.query_minimizers(b, k, w)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FIXTURES)
def test_genome_and_seed_table_equal_jax(name, monkeypatch):
    """The genome layout, and the seed table both with the port's native
    library and with its NumPy fallback."""
    params, jparams, reads, jreads = _fixture(name)
    g, jg = Genome(reads, params.bin_size), JaxGenome(jreads, jparams.bin_size)
    for f in ("concat", "piece_lengths", "chr_id_to_start_bin",
              "bin_to_chr_id"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f), f)
    assert g.names == jg.names and g.total_length == jg.total_length
    hits = np.arange(0, g.total_length, 97)
    for a, b in zip(g.decode_hits(hits), jg.decode_hits(hits)):
        np.testing.assert_array_equal(a, b)
    args = (g.concat, params.seed_size, params.seed_occurence_multiple,
            params.bin_size, params.window_size)
    want = JaxSeedTable.build(*args)
    for with_native in (True, False):
        if not with_native:
            monkeypatch.setattr(native, "available", lambda: False)
        got = SeedTable.build(*args)
        np.testing.assert_array_equal(got.hashes, want.hashes)
        np.testing.assert_array_equal(got.pos, want.pos)
        assert vars(got).keys() == vars(want).keys()
        assert all(vars(got)[k] == vars(want)[k] for k in
                   ("k", "w", "bin_size", "ref_size", "kmer_max_occurence"))


@pytest.mark.parametrize("name", FIXTURES)
def test_host_dsoft_equals_jax(name):
    params, _, reads, _ = _fixture(name)
    table = SeedTable.build(Genome(reads, params.bin_size).concat,
                            params.seed_size, params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    n = 0
    for r in reads[:16]:
        b = coding.seq_to_bytes(r.seq)
        got = dsoft_filter.dsoft(table, b, params.num_seeds,
                                 params.threshold, params.max_candidates)
        want = jax_filter.dsoft(table, b, params.num_seeds, params.threshold,
                                params.max_candidates)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)
        n += len(got[0])
    assert n > 0


def test_format_record_and_bucket_steps_equal_jax():
    for args in [("chr1", "r7", 0, 120, 5, 130, 97, True),
                 ("a_b", "R1_2_3_c", 10 ** 6, 10 ** 6 + 5, 0, 4, -3, False)]:
        assert format_record(*args) == jax_format_record(*args)
    for n in (0, 1, 63, 64, 65, 95, 96, 97, 129, 1000, 4097):
        assert utils.bucket_steps(n) == jax_utils.bucket_steps(n)
        assert utils.bucket_steps(n, 16) == jax_utils.bucket_steps(n, 16)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_datagen_byte_equal_jax(seed):
    g = datagen.synth_genome(20_000, np.random.default_rng(seed))
    assert g == jax_datagen.synth_genome(20_000, np.random.default_rng(seed))
    kw = dict(error_rate=0.12, rc_fraction=0.5)
    assert datagen.sample_reads(g, 12, 1500, np.random.default_rng(seed),
                                **kw) == jax_datagen.sample_reads(
        g, 12, 1500, np.random.default_rng(seed), **kw)
    assert datagen.sample_reads(
        g, 6, 900, np.random.default_rng(seed), read_len_range=(500, 1500),
        **kw) == jax_datagen.sample_reads(
        g, 6, 900, np.random.default_rng(seed), read_len_range=(500, 1500),
        **kw)
    a, b = datagen.two_readsets(g, 5, 2000, np.random.default_rng(seed),
                                **kw)
    ja, jb = jax_datagen.two_readsets(g, 5, 2000, np.random.default_rng(seed),
                                      **kw)
    assert (a, b) == (ja, jb)
    names = [n for n, _ in a]
    assert score_eval.theoretical_pairs(names, [n for n, _ in b], 300) == \
        jax_score_eval.theoretical_pairs(names, [n for n, _ in b], 300)
    assert score_eval._ints(names[0]) == jax_score_eval._ints(names[0])
    assert datagen.overlap_pairs(
        7, 1200, 200, 900, np.random.default_rng(seed)) == \
        jax_datagen.overlap_pairs(7, 1200, 200, 900,
                                  np.random.default_rng(seed))


@pytest.mark.parametrize("seed", [101, 202, 303, 404, 505, 7032])
def test_fuzz_instances_equal_the_jax_tests(seed):
    """tools/torch_fuzz_soak.py's _instance gives
    tests/test_fuzz_pipeline.py's params and reads for its pinned seeds,
    and the same batch size."""
    from tests import test_fuzz_pipeline as jfz

    fz = _tool("torch_fuzz_soak")
    params, reads = fz._instance(seed)
    jparams, jreads = jfz._instance(seed)
    assert dataclasses.asdict(params) == dataclasses.asdict(jparams)
    assert [(r.fields, r.seq) for r in reads] == \
        [(r.fields, r.seq) for r in jreads]
    assert fz.instance(seed, False)[4] == int(
        np.random.default_rng(seed).choice([8, 32, 64]))
    assert seed in fz.PINNED


@pytest.mark.parametrize("seed", [606, 707, 808])
def test_guided_fuzz_instances_equal_the_jax_tests(seed):
    from tests import test_fuzz_pipeline as jfz

    fz = _tool("torch_fuzz_soak")
    params, chroms, reads = fz._guided_instance(seed)
    jparams, jchroms, jreads = jfz._guided_instance(seed)
    assert dataclasses.asdict(params) == dataclasses.asdict(jparams)
    for got, want in ((chroms, jchroms), (reads, jreads)):
        assert [(r.fields, r.seq) for r in got] == \
            [(r.fields, r.seq) for r in want]
    assert seed in fz.PINNED_GUIDED


@pytest.mark.parametrize("name", FIXTURES)
def test_sharded_table_helpers_equal_jax(name):
    """shard_bounds, make_sharded_table, make_sharded_dense_index and
    derive_budgets (budgets and the stats behind them) on the fixture's
    table and reads, over 1, 3 and 8 shards."""
    params, _, reads, _ = _fixture(name)
    table = SeedTable.build(Genome(reads, params.bin_size).concat,
                            params.seed_size, params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    seqs = [coding.seq_to_bytes(r.seq) for r in reads[:12]]
    for n in (1, 3, 8):
        assert sharded_table.shard_bounds(table.hashes, n) == \
            jax_sharded.shard_bounds(table.hashes, n)
        got = sharded_table.make_sharded_table(table.hashes, table.pos, n)
        want = jax_sharded.make_sharded_table(table.hashes, table.pos, n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        gi = sharded_table.make_sharded_dense_index(got[0])
        wi = jax_sharded.make_sharded_dense_index(want[0])
        for f in ("hd", "crs", "bkt", "base", "shift"):
            np.testing.assert_array_equal(getattr(gi, f), getattr(wi, f), f)
            assert getattr(gi, f).dtype == getattr(wi, f).dtype, f
        assert gi.steps == wi.steps
        kw = dict(num_seeds_cap=params.num_seeds, threshold=params.threshold,
                  max_candidates=params.max_candidates)
        assert dataclasses.asdict(sharded_table.derive_budgets(
            table, seqs, n, **kw)) == dataclasses.asdict(
            jax_sharded.derive_budgets(table, seqs, n, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_read_range_and_balance_calls_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n, count = int(rng.integers(0, 200)), int(rng.integers(1, 9))
        assert [distributed.read_range(n, i, count) for i in range(count)] \
            == [jax_distributed.read_range(n, i, count)
                for i in range(count)]
        costs = rng.integers(1, 10_000, size=n) * (1 + 20 * (
            rng.random(n) < 0.2))
        for g, w in zip(device_batch.balance_calls(costs, count),
                        jax_device_batch.balance_calls(costs, count)):
            np.testing.assert_array_equal(g, w)
