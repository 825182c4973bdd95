"""darwin_tpu_torch.dsoft.device against darwin_tpu.dsoft.device and the
golden scalar spec, on the CPU (the plain version; csrc/dsoft.cu runs
in test_torch_cuda.py).

* dsoft_device_batch under each index mode against darwin_tpu's on the
  same numpy inputs, all four outputs equal (tolerance 0: every output
  is an integer), and against dsoft_scalar;
* every case of tests/test_dsoft_device.py but the sharded one, against
  the port's golden dsoft_scalar: N bases with a num_seeds cap of 40,
  max_candidates 2, the tuple budget's overflow flag, cand_max 1, empty
  and 4-base reads, positions past 2^31, the dense and two-level
  indexes;
* chip_smoke's budget-edge cases (reads below, at and above csrc/
  dsoft.cu's shared-memory tuple budget) against darwin_tpu's, and the
  budget's mirror against the kernel's constant;
* the host helpers (make_twolevel_index, bucket_directory, pad_reads,
  dense_hash_index) against darwin_tpu's;
* collect_calls_device(device="cpu") against the port's collect_calls
  and darwin_tpu's collect_calls_device;
* the CLI with --dsoft device --device cpu on tiny, under both engines,
  byte-identical to darwin_tpu.cli --backend lax --dsoft device.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from darwin_tpu import cli as jax_cli
from darwin_tpu.dsoft import device as jdev
from darwin_tpu.engine.seqbank import SeqBank as JaxSeqBank
from darwin_tpu.golden.dsoft import GoldenSeedTable as JaxGoldenSeedTable
from darwin_tpu_torch import cli
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.dsoft import device as dev
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.golden.dsoft import dsoft_scalar
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import FastaRecord
from darwin_tpu_torch.pipeline import collect_calls, collect_calls_device
from tests._torch_threads import one_torch_thread  # noqa: F401

ALPHA = np.frombuffer(b"ACGTN", dtype=np.uint8)
CPU = torch.device("cpu")


# tests/test_dsoft_device.py's instances on the port's golden table.
_fixture = chip_smoke.dsoft_fixture


def _kw(gt, threshold=18, cap_seeds=800, cap_cand=10**6, tup_max=8192,
        cand_max=256):
    return dict(k=gt.k, w=gt.w, bin_size=gt.bin_size,
                kmer_max_occ=gt.kmer_max_occurence, num_seeds_cap=cap_seeds,
                threshold=threshold, max_candidates=cap_cand,
                tup_max=tup_max, cand_max=cand_max)


def _run_port(gt, reads, index="searchsorted", **kw):
    """The port on the CPU; returns numpy outputs, hits as uint32."""
    Q, lens = dev.pad_reads(SeqBank(reads), range(len(reads)))
    th, tpos, steps = dev.device_index(gt.hashes, gt.pos_table, k=gt.k,
                                       index=index, device=CPU)
    out = dev.dsoft_device_batch(torch.from_numpy(Q), torch.from_numpy(lens),
                                 th, tpos, index=index, tl_steps=steps,
                                 **_kw(gt, **kw))
    hits, offs, counts, over = (x.numpy() for x in out)
    assert hits.dtype == np.int64 and offs.dtype == np.int32
    assert ((hits >= 0) & (hits <= 0xFFFFFFFF)).all()
    return hits.astype(np.uint32), offs, counts, over


def _check_parity(gt, reads, out, threshold=18, cap_seeds=800,
                  cap_cand=10**6):
    hits, offs, counts, over = out
    for i, r in enumerate(reads):
        assert not over[i], f"read {i} overflowed"
        gold = dsoft_scalar(gt, r, cap_seeds, threshold, cap_cand)
        got = list(zip(hits[i, :counts[i]].tolist(),
                       offs[i, :counts[i]].tolist()))
        assert got == gold, f"read {i}"
        assert (hits[i, counts[i]:].astype(np.int32) == -1).all()
        assert (offs[i, counts[i]:] == -1).all()


@pytest.mark.parametrize("index", ["searchsorted", "dense", "twolevel"])
def test_port_equals_jax_under_each_index_mode(index):
    """The same numpy inputs through darwin_tpu's dsoft_device_batch and
    the port's, all four outputs equal; and the golden spec's
    candidates."""
    gt, reads = _fixture(3)
    Q, lens = jdev.pad_reads(JaxSeqBank(reads), range(len(reads)))
    kw = _kw(gt)
    if index == "twolevel":
        tl = jdev.make_twolevel_index(np.asarray(gt.hashes))
        th, extra = tl[:5], dict(tl_steps=tl[5])
    elif index == "dense":
        th, extra = jdev.dense_hash_index(gt.hashes, gt.k), {}
    else:
        th, extra = gt.hashes, {}
    want = [np.asarray(x) for x in jdev.dsoft_device_batch(
        Q, lens, th, gt.pos_table, index=index, **extra, **kw)]
    got = _run_port(gt, reads, index=index)
    assert want[0].dtype == np.uint32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].sum() > 0
    _check_parity(gt, reads, got)


@pytest.mark.parametrize("seed,threshold", [(3, 18), (7, 12), (11, 21)])
def test_port_matches_golden(seed, threshold):
    gt, reads = _fixture(seed)
    _check_parity(gt, reads, _run_port(gt, reads, threshold=threshold),
                  threshold=threshold)


def test_port_with_n_bases_and_num_seeds_cap():
    gt, reads = _fixture(19, n_frac=0.03)
    out = _run_port(gt, reads, threshold=15, cap_seeds=40)
    _check_parity(gt, reads, out, threshold=15, cap_seeds=40)


def test_port_max_candidates_cap():
    gt, reads = _fixture(23)
    out = _run_port(gt, reads, threshold=12, cap_cand=2)
    _check_parity(gt, reads, out, threshold=12, cap_cand=2)
    assert (out[2] <= 2).all()


def test_port_tuple_overflow_flagged():
    """A tuple budget of 8 raises the flag where a read has more tuples;
    the outputs are still darwin_tpu's slot for slot (cand_max 256 pads
    past the budget)."""
    gt, reads = _fixture(5, n_reads=4)
    hits, offs, counts, over = _run_port(gt, reads, threshold=12, tup_max=8)
    assert over.any()
    assert (counts <= 8).all()
    assert (hits[:, 8:].astype(np.int32) == -1).all()


def test_port_cand_max_below_emissions_flagged():
    gt, reads = _fixture(29, err=0.02)
    hits, offs, counts, over = _run_port(gt, reads, threshold=12,
                                         cand_max=1)
    for i, r in enumerate(reads):
        gold = dsoft_scalar(gt, r, 800, 12, 10**6)
        if len(gold) > 1:
            assert over[i]
            assert (hits[i, 0], offs[i, 0]) == gold[0]
        else:
            assert counts[i] == len(gold)


def test_port_empty_and_short_reads():
    gt, _ = _fixture(31, n_reads=1)
    reads = [np.frombuffer(b"ACGT", dtype=np.uint8).copy(),
             np.frombuffer(b"A" * 40, dtype=np.uint8).copy(),
             np.zeros(0, dtype=np.uint8)]
    _check_parity(gt, reads, _run_port(gt, reads))


def test_port_positions_past_2_31():
    """A table whose positions lie past 2^31 (a GRCh38-scale concat):
    hits stay uint32 end to end and match the golden spec."""
    gt, reads = _fixture(13)
    shift = np.uint64(2_600_000_000)
    gt.pos_table = (gt.pos_table.astype(np.uint64) + shift).astype(np.uint32)
    gt.ref_size += int(shift)
    out = _run_port(gt, reads)
    real = np.concatenate([out[0][i, :out[2][i]] for i in range(len(reads))])
    assert (real.astype(np.uint64) > np.uint64(2**31)).any()
    _check_parity(gt, reads, out)


@pytest.mark.parametrize("index", ["dense", "twolevel"])
@pytest.mark.parametrize("seed", [3, 11])
def test_port_index_modes_match_searchsorted_and_golden(seed, index):
    gt, reads = _fixture(seed)
    want = _run_port(gt, reads)
    got = _run_port(gt, reads, index=index)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _check_parity(gt, reads, got)


@pytest.mark.parametrize("index", ["searchsorted", "dense", "twolevel"])
@pytest.mark.parametrize("seed,limits", [(19, dict(num_seeds_cap=40)),
                                         (3, dict(tup_max=64))])
def test_bound_work_holds_all_the_output_reads(seed, limits, index):
    """chip_smoke.dsoft_work counts what the output depends on: read
    bytes past each read's count and table_pos entries outside the
    sectors it counts may change without changing the output, and no
    lookup is counted at more sectors than its loads."""
    gt, reads = _fixture(seed, n_frac=0.03)
    ckw = dict(threshold=15, num_seeds_cap=800, max_candidates=10**6,
               tup_max=8192, cand_max=256)
    args, kw = chip_smoke.dsoft_case_args(gt, reads, {**ckw, **limits},
                                          index, CPU)
    want = dev.dsoft_device_batch(*args, **kw)
    work = chip_smoke.dsoft_work(args, kw)
    Q, lens, th, tpos = args
    rng = np.random.default_rng(seed)
    Q2 = Q.clone()
    for r, n in enumerate(work["read_bytes"]):
        Q2[r, n:] = torch.from_numpy(rng.choice(ALPHA[:4], Q.shape[1] - n))
    assert (np.array(work["read_bytes"]) < lens.numpy()).any()
    tpos2 = tpos.clone()
    outside = torch.ones(tpos.shape[0], dtype=torch.bool)
    outside[(work["sectors"]["table_pos"][:, None] * 8
             + torch.arange(8)).reshape(-1).clamp(max=tpos.shape[0] - 1)] = False
    tpos2[outside] = torch.from_numpy(rng.integers(
        0, 2**31, int(outside.sum()), dtype=np.int32))
    assert outside.any()
    for got in (dev.dsoft_device_batch(Q2, lens, th, tpos, **kw),
                dev.dsoft_device_batch(Q, lens, th, tpos2, **kw)):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    # A run of n >= 1 hits spans at most n sectors; a lookup loads at
    # most its loads' sectors (one lookup a scanned position at most;
    # the two-level index also loads base and shift, once).
    sectors = work["sectors"]
    assert sectors["table_pos"].numel() <= sum(work["tuples"])
    loads = {"twolevel": kw["tl_steps"] + 5, "dense": 2}.get(index)
    if loads:
        assert sum(v.numel() for a, v in sectors.items()
                   if a != "table_pos") <= loads * work["scanned"] + 2




def test_smem_budget_mirrors_the_kernel():
    """chip_smoke.DSOFT_SMEM_TUPLES is csrc/dsoft.cu's kSmemTuples."""
    src = (Path(chip_smoke.__file__).parent / "darwin_tpu_torch" / "csrc"
           / "dsoft.cu").read_text()
    m = re.search(r"constexpr int kSmemTuples = (\d+);", src)
    assert m and int(m.group(1)) == chip_smoke.DSOFT_SMEM_TUPLES


def test_budget_reads_straddle_the_kernel_budget():
    """One batch holds a read below, at and just above the kernel's
    shared-memory tuple budget, one far above it and a short one; under
    tup_max 1200 the far one overflows, under tup_max = the budget the
    two above it do, under 8192 and 32768 none."""
    tb = chip_smoke.DSOFT_SMEM_TUPLES
    totals = {}
    for name, gt, reads, kw in chip_smoke.dsoft_budget_cases():
        args, akw = chip_smoke.dsoft_case_args(gt, reads, kw, "searchsorted",
                                               CPU)
        totals[kw["tup_max"]] = chip_smoke._dsoft_steps(args, akw)[
            "cum"][:, -1].tolist()
        over = dev.dsoft_device_batch(*args, **akw)[3].tolist()
        assert over == [t > kw["tup_max"] for t in totals[kw["tup_max"]]]
    t = totals[8192]
    assert t[0] < tb - 1 and t[1:3] == [tb - 1, tb]
    assert tb < t[3] <= tb + 3 and t[4] > 1200
    assert len(set(map(tuple, totals.values()))) == 1
    assert sorted(totals) == [tb, 1200, 8192, 32768]


@pytest.mark.parametrize("index", ["searchsorted", "dense", "twolevel"])
@pytest.mark.parametrize("case", range(len(chip_smoke.BUDGET_TUP_MAX)),
                         ids=[f"tup_max {t}"
                              for t in chip_smoke.BUDGET_TUP_MAX])
def test_port_equals_jax_across_the_smem_budget(case, index):
    """chip_smoke's budget-edge cases (reads below, at and above the
    kernel's shared-memory tuple budget, one overflowing tup_max) through
    darwin_tpu's dsoft_device_batch and the port's, all four outputs
    equal (tolerance 0); reads that did not overflow also give
    dsoft_scalar's candidates."""
    name, gt, reads, kw = chip_smoke.dsoft_budget_cases()[case]
    args, akw = chip_smoke.dsoft_case_args(gt, reads, kw, index, CPU)
    got = [x.numpy() for x in dev.dsoft_device_batch(*args, **akw)]
    Q, lens = jdev.pad_reads(JaxSeqBank(list(reads)), range(len(reads)))
    if index == "twolevel":
        th = jdev.make_twolevel_index(np.asarray(gt.hashes))[:5]
    elif index == "dense":
        th = jdev.dense_hash_index(gt.hashes, gt.k)
    else:
        th = gt.hashes
    want = [np.asarray(x) for x in jdev.dsoft_device_batch(
        Q, lens, th, gt.pos_table, index=index, tl_steps=akw["tl_steps"],
        **{k: v for k, v in akw.items() if k not in ("index", "tl_steps")})]
    np.testing.assert_array_equal(got[0].astype(np.uint32), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    hits, offs, counts, over = got
    for i, r in enumerate(reads):
        if not over[i]:
            gold = dsoft_scalar(gt, r, kw["num_seeds_cap"], kw["threshold"],
                                kw["max_candidates"])
            assert list(zip(hits[i, :counts[i]].tolist(),
                            offs[i, :counts[i]].tolist())) == gold, i


def test_bad_index_mode_raises():
    gt, reads = _fixture(3, n_reads=1)
    with pytest.raises(ValueError, match="index"):
        _run_port(gt, reads, index="hashmap")


@pytest.mark.parametrize("seed", [3, 31])
def test_host_helpers_equal_jax(seed):
    """make_twolevel_index (and bucket_directory under it), pad_reads,
    dense_hash_index and default_index_mode equal darwin_tpu's, on the
    golden table's hashes, an empty table, and a bank with an empty
    read."""
    gt, reads = _fixture(seed, n_reads=4)
    jt = JaxGoldenSeedTable(np.concatenate(reads), 12, 32, 64, 4)
    for hashes in (gt.hashes, jt.hashes, np.zeros(0, np.uint32)):
        got, want = (dev.make_twolevel_index(hashes),
                     jdev.make_twolevel_index(hashes))
        assert got[5] == want[5]
        for g, w in zip(got[:5], want[:5]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    rel = np.sort(np.random.default_rng(seed).integers(0, 1000, size=300))
    np.testing.assert_array_equal(dev.bucket_directory(rel, 1000),
                                  jdev.bucket_directory(rel, 1000))
    reads = reads + [np.zeros(0, np.uint8)]
    for ids, L in ((range(len(reads)), None), ([2, 0, 4], 3000)):
        got = dev.pad_reads(SeqBank(reads), ids, L)
        want = jdev.pad_reads(JaxSeqBank(reads), ids, L)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    csr = dev.dense_hash_index(torch.from_numpy(gt.hashes.view(np.int32)),
                               gt.k)
    np.testing.assert_array_equal(
        csr.numpy(), np.asarray(jdev.dense_hash_index(gt.hashes, gt.k)))
    assert dev.default_index_mode(gt.k) == jdev.default_index_mode(gt.k)


def _table_and_bank(seed, n_reads, lo, hi, ref_len):
    """test_dsoft_device.py's collect_calls_device set-up, on the port's
    modules: a random reference, reads drawn from it at 10% error."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(ALPHA[:4], size=ref_len).astype(np.uint8)
    params = Params(seed_size=12, threshold=15)
    genome = Genome([FastaRecord(["ref"], ref.tobytes().decode())],
                    params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size)
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, ref_len - hi))
        r = ref[s:s + int(rng.integers(lo, hi))].copy()
        mut = rng.random(len(r)) < 0.1
        r[mut] = rng.choice(ALPHA[:4], size=int(mut.sum()))
        reads.append(r)
    return params, genome, table, reads


def _same_calls(a, b):
    for f in ("ref_id", "query_id", "ref_pos", "query_pos"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("index", ["auto", "searchsorted", "dense"])
def test_collect_calls_device_matches_host_and_jax(index):
    """collect_calls_device on the CPU: the port's collect_calls exactly,
    and darwin_tpu's collect_calls_device; the index cached on the table
    (the two-level host arrays as darwin_tpu caches them)."""
    from darwin_tpu.config import Params as JaxParams
    from darwin_tpu.index.genome import Genome as JaxGenome
    from darwin_tpu.index.seed_table import SeedTable as JaxSeedTable
    from darwin_tpu.io.fasta import FastaRecord as JaxFastaRecord
    from darwin_tpu.pipeline import collect_calls_device as jax_ccd

    params, genome, table, reads = _table_and_bank(41, 9, 500, 2000, 30000)
    bank = SeqBank(reads)
    host = collect_calls(table, genome, bank, params)
    m = {}
    got = collect_calls_device(table, genome, bank, params, index=index,
                               device="cpu", metrics=m)
    _same_calls(got, host)
    assert len(host) > 0 and m["dsoft_overflow_reads"] == 0
    assert m.keys() == {"dsoft_overflow_reads", "dsoft_index_s"}
    key = ("twolevel" if index == "auto" else index, "cpu")
    assert key in table._device_index
    if index == "auto":
        assert table._twolevel is not None
        # A second call uploads only the reads.
        cached = table._device_index[key]
        _same_calls(collect_calls_device(table, genome, bank, params,
                                         read_ids=[3, 1], device="cpu"),
                    collect_calls(table, genome, bank, params,
                                  read_ids=[3, 1]))
        assert table._device_index[key] is cached
        jp = JaxParams(seed_size=12, threshold=15)
        jg = JaxGenome([JaxFastaRecord(["ref"], genome.concat.tobytes()
                                       .decode())], jp.bin_size)
        jt = JaxSeedTable.build(jg.concat, jp.seed_size,
                                jp.seed_occurence_multiple, jp.bin_size,
                                jp.window_size)
        _same_calls(got, jax_ccd(jt, jg, JaxSeqBank(reads), jp))


def test_collect_calls_device_overflow_falls_back_to_host():
    """A tuple budget every read overflows: each takes the host D-SOFT,
    the calls are collect_calls', and metrics count the reads."""
    params, genome, table, reads = _table_and_bank(13, 6, 500, 2500, 20000)
    bank = SeqBank(reads)
    m = {}
    got = collect_calls_device(table, genome, bank, params, tup_max=4,
                               device="cpu", metrics=m)
    _same_calls(got, collect_calls(table, genome, bank, params))
    assert m["dsoft_overflow_reads"] == len(reads)
    empty = collect_calls_device(table, genome, bank, params, read_ids=[],
                                 device="cpu")
    assert len(empty) == 0


FILES = ("darwin.0.out", "darwin.1.out", "merged")


@pytest.mark.parametrize("engine", ["device", "host"])
def test_cli_dsoft_device_files_match_jax_cli(data_dir, tmp_path, engine):
    """--dsoft device on tiny, by the engine given: the port's files are
    darwin_tpu.cli's (lax backend, the same engine) byte for byte, and
    the metrics say dsoft device with no overflowed read."""
    import json

    d = data_dir / "tiny"

    def args(out, *extra):
        return [str(d / "reads.fasta"), str(d / "reads.fasta"), "2",
                "--params", str(d / "params.cfg"), "--batch-size", "64",
                "--out-dir", str(out), "--merged-out", str(out / "merged"),
                "--engine", engine, "--dsoft", "device", *extra]

    jout, pout = tmp_path / "jax", tmp_path / "port"
    assert jax_cli.main(args(jout, "--backend", "lax")) == 0
    assert cli.main(args(pout, "--device", "cpu", "--metrics-json",
                         str(pout / "m.json"))) == 0
    for name in FILES:
        assert (pout / name).read_bytes() == (jout / name).read_bytes(), name
    assert (pout / "merged").read_text().splitlines() == sorted(
        set((d / "out.darwin").read_text().splitlines()))
    m = json.loads((pout / "m.json").read_text())
    assert (m["dsoft"], m["dsoft_overflow_reads"]) == ("device", 0)
