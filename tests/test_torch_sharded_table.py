"""darwin_tpu_torch's table-sharded D-SOFT against darwin_tpu's, on a
mesh of the same size (8: tests/conftest.py gives JAX 8 virtual CPU
devices; the port's mesh is ["cpu"] * 8), since shard bounds, budgets
and overflow flags depend on it.

* dsoft_table_sharded (its steps' plain versions on CPU tensors) and
  dsoft_table_sharded_torch against dsoft_table_sharded_fn, bit-exact on
  hits, offsets, counts and overflow, on chip_smoke.SHARDED_CASES (the
  cases phase 9 runs on the card) under both exchanges and both index
  modes: tests/test_sharded_table.py's fixtures (chip_smoke's copy of
  its _fixture is held to it), the num_seeds and max_candidates caps, a
  tup_max and an a2a_cap that overflow, a table past 2^31, and reads of
  thousands of tuples (past the count kernel's register budget);
* collect_calls_table_sharded (derived budgets, both exchanges, mesh
  sizes 8 and 1) and collect_calls_device(mesh=) against the host
  collect_calls;
* chip_smoke's synthetic shard_count cases (phase 9 and the card tests
  hold the count kernel to its plain version on them): reads at exactly
  the stated tuple counts, at each of the kernel's forms' edges, whose
  budgets chip_smoke mirrors from the source; and dsoft_table_sharded's
  step marks.
(The host helpers' copies are held to theirs in test_torch_standalone.py.)
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from darwin_tpu.dsoft.device import pad_reads as jax_pad_reads
from darwin_tpu.dsoft.sharded_table import (dsoft_table_sharded_fn,
                                            make_sharded_dense_index,
                                            make_sharded_table)
from darwin_tpu.engine.seqbank import SeqBank as JaxSeqBank
from darwin_tpu.parallel.mesh import make_mesh as jax_make_mesh
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.dsoft import sharded_table as st
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import FastaRecord
from darwin_tpu_torch.parallel.mesh import make_mesh
from darwin_tpu_torch.pipeline import (collect_calls, collect_calls_device,
                                       collect_calls_table_sharded)
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_sharded_table import _fixture

import chip_smoke

ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)
P = 8



@pytest.mark.parametrize("name", [n for n, c in chip_smoke.SHARDED_CASES.items()
                                  if "unit" not in c[0]])
def test_chip_smoke_fixture_is_the_jax_tests(name):
    """chip_smoke.sharded_fixture, whose cases phase 9 runs on the card,
    makes tests/test_sharded_table.py's instances."""
    fx = chip_smoke.SHARDED_CASES[name][0]
    gt, reads = chip_smoke.sharded_fixture(**fx)
    jgt, jreads = _fixture(**fx)
    np.testing.assert_array_equal(gt.hashes, jgt.hashes)
    np.testing.assert_array_equal(gt.pos_table, jgt.pos_table)
    assert gt.kmer_max_occurence == jgt.kmer_max_occurence
    assert len(reads) == len(jreads)
    for r, jr in zip(reads, jreads):
        np.testing.assert_array_equal(r, jr)


@pytest.mark.parametrize("index", ["searchsorted", "dense"])
@pytest.mark.parametrize("exchange", ["all_gather", "all_to_all"])
@pytest.mark.parametrize("name", list(chip_smoke.SHARDED_CASES))
def test_table_sharded_equals_jax(name, exchange, index):
    gt, reads, kw, a2a, over = chip_smoke.sharded_case(name)
    a2a_cap = a2a if exchange == "all_to_all" else None
    hs, ps = make_sharded_table(gt.hashes, gt.pos_table, P)
    di = make_sharded_dense_index(hs)
    fn = dsoft_table_sharded_fn(jax_make_mesh(P), a2a_cap=a2a_cap,
                                index=index, dense_steps=di.steps, **kw)
    Q, lens = jax_pad_reads(JaxSeqBank(reads), range(len(reads)))
    extra = (di.hd, di.crs, di.bkt, di.base, di.shift) \
        if index == "dense" else ()
    want = jax.device_get(fn(Q, lens, hs, ps, *extra))
    assert bool(want[3].any()) == over[exchange == "all_gather"]

    mesh = make_mesh(devices=["cpu"] * P)
    shards = st.place_shards(mesh, hs, ps, di if index == "dense" else None)
    args = (mesh, torch.from_numpy(Q), torch.from_numpy(lens), shards)
    kw.update(a2a_cap=a2a_cap, index=index, dense_steps=di.steps)
    for got in (st.dsoft_table_sharded(*args, **kw),
                st.dsoft_table_sharded_torch(*args, **kw)):
        hits, offs, counts, overflow = (x.numpy() for x in got)
        assert hits.dtype == np.int64 and offs.dtype == np.int32
        np.testing.assert_array_equal(hits.astype(np.uint32), want[0])
        np.testing.assert_array_equal(offs, want[1])
        np.testing.assert_array_equal(counts, want[2])
        np.testing.assert_array_equal(overflow, want[3])
    if name == "positions past 2^31":
        assert (hits[hits != 0xFFFFFFFF] > 2 ** 31).any()


@pytest.fixture(scope="module")
def seeding():
    """darwin_tpu's test_collect_calls_table_sharded_matches_host
    instance on the port: a 60 kb reference, 16 reads of 800-2500 bases
    at 10% substitutions, k = 12, threshold 12."""
    rng = np.random.default_rng(71)
    ref = rng.choice(ALPHA, size=60_000).astype(np.uint8)
    params = Params(seed_size=12, threshold=12)
    table = SeedTable.build(ref, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size)
    genome = Genome([FastaRecord(["g"], ref.tobytes().decode())],
                    params.bin_size)
    reads = []
    for _ in range(16):
        s = int(rng.integers(0, 55_000))
        r = ref[s:s + int(rng.integers(800, 2500))].copy()
        mut = rng.random(len(r)) < 0.1
        r[mut] = rng.choice(ALPHA, size=int(mut.sum()))
        reads.append(r)
    bank = SeqBank(reads)
    want = collect_calls(table, genome, bank, params)
    assert len(want) > 0
    return table, genome, bank, params, want


def _same_calls(got, want):
    assert len(got) == len(want)
    for f in ("ref_id", "query_id", "ref_pos", "query_pos"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("n", [P, 1])
@pytest.mark.parametrize("exchange", ["all_to_all", "all_gather"])
def test_collect_calls_table_sharded_equals_host(seeding, exchange, n):
    table, genome, bank, params, want = seeding
    metrics = {}
    got = collect_calls_table_sharded(
        table, genome, bank, params, make_mesh(devices=["cpu"] * n),
        exchange=exchange, metrics=metrics)
    _same_calls(got, want)
    assert table._budget_cache[0] == n and metrics["dsoft_overflow_reads"] \
        == 0
    # A later batch reuses the table's budgets, shards and placements.
    again = collect_calls_table_sharded(
        table, genome, bank, params, make_mesh(devices=["cpu"] * n),
        read_ids=range(3, 11), exchange=exchange)
    keep = (want.query_id >= 3) & (want.query_id < 11)
    _same_calls(again, type(want)(*(getattr(want, f)[keep] for f in (
        "ref_id", "query_id", "ref_pos", "query_pos"))))


@pytest.mark.parametrize("n", [3, P])
def test_collect_calls_device_mesh_equals_host(seeding, n):
    """sharded_dsoft: the reads in blocks over the mesh (16 reads padded
    to a multiple of 3), the two-level index on every entry, and a
    tuple budget that sends some reads to the host fallback."""
    table, genome, bank, params, want = seeding
    mesh = make_mesh(devices=["cpu"] * n)
    _same_calls(collect_calls_device(table, genome, bank, params,
                                     mesh=mesh), want)
    metrics = {}
    _same_calls(collect_calls_device(table, genome, bank, params, mesh=mesh,
                                     tup_max=64, metrics=metrics), want)
    assert metrics["dsoft_overflow_reads"] > 0


def test_shard_count_budgets_mirror_the_kernel():
    """chip_smoke's SHARD_COUNT_REG_TUPLES and SHARD_COUNT_SMEM_TUPLES are
    csrc/dsoft_sharded.cu's kRegTuples and kSmemTuples."""
    src = (Path(chip_smoke.__file__).parent / "darwin_tpu_torch" / "csrc"
           / "dsoft_sharded.cu").read_text()
    got = [int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
           for name in ("kRegTuples", "kSmemTuples")]
    assert got == [chip_smoke.SHARD_COUNT_REG_TUPLES,
                   chip_smoke.SHARD_COUNT_SMEM_TUPLES]


@pytest.mark.parametrize("name", list(chip_smoke.SHARD_COUNT_CASES))
def test_shard_count_cases_hold_the_stated_reads(name):
    """Each synthetic read has exactly its stated tuple count, grouped as
    the exchange gives them (distinct (offset, hit) pairs in that order,
    hit >= offset, tuples of no read around them), and the longer reads
    cross threshold in several bins."""
    _, sizes, kw = chip_smoke.SHARD_COUNT_CASES[name]
    hit, off, seg, ckw = chip_smoke.shard_count_case(name)
    assert ckw == kw and hit.dtype == np.uint32 and off.dtype == np.int32
    assert np.diff(seg).tolist() == list(sizes)
    assert 0 < seg[0] and seg[-1] < len(hit)
    assert (hit.astype(np.int64) >= off).all()
    for a, b in zip(seg[:-1], seg[1:]):
        pairs = off[a:b].astype(np.int64) * 2 ** 32 + hit[a:b]
        assert (np.diff(pairs) > 0).all()
    args, _ = chip_smoke.shard_count_case_args(name, "cpu")
    _, _, counts, _ = st.shard_count_torch(*args, **kw)
    assert all(c >= 4 for n, c in zip(sizes, counts.tolist())
               if n >= chip_smoke.SHARD_COUNT_REG_TUPLES)


def test_shard_count_cases_reach_every_form():
    """Over the synthetic cases, reads sit at 0 tuples, at each side of
    the register budget and of the shared-memory budget, and past it."""
    reg = chip_smoke.SHARD_COUNT_REG_TUPLES
    smem = chip_smoke.SHARD_COUNT_SMEM_TUPLES
    sizes = {n for _, ns, _ in chip_smoke.SHARD_COUNT_CASES.values()
             for n in ns}
    assert {0, reg, reg + 1, smem, smem + 1} <= sizes
    assert max(sizes) > smem + 1
    forms = np.sum([chip_smoke.count_forms(torch.from_numpy(
        chip_smoke.shard_count_case(name)[2]))
        for name in chip_smoke.SHARD_COUNT_CASES], axis=0)
    assert forms.tolist() == [8, 4, 3]


@pytest.mark.parametrize("exchange", ["all_gather", "all_to_all"])
def test_table_sharded_marks_each_step(exchange):
    """dsoft_table_sharded's mark is called as each step ends, in launch
    order, and changes nothing."""
    gt, reads, kw, a2a, _ = chip_smoke.sharded_case("seed 17")
    hs, ps = make_sharded_table(gt.hashes, gt.pos_table, P)
    di = make_sharded_dense_index(hs)
    Q, lens = jax_pad_reads(JaxSeqBank(reads), range(len(reads)))
    mesh = make_mesh(devices=["cpu"] * P)
    args = (mesh, torch.from_numpy(Q), torch.from_numpy(lens),
            st.place_shards(mesh, hs, ps, di))
    kw.update(a2a_cap=a2a if exchange == "all_to_all" else None,
              index="dense", dense_steps=di.steps)
    marks = []
    got = st.dsoft_table_sharded(*args, mark=marks.append, **kw)
    assert marks == (["scan"] * P + ["tuples", "exchange"]
                     + ["group", "count"] * P)
    for g, w in zip(got, st.dsoft_table_sharded(*args, **kw)):
        assert torch.equal(g, w)
