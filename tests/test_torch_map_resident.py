"""The map path against a resident reference, on the CPU:

* pipeline.read_banks builds both banks over the batch's bytes at once
  (io/fasta.revcomp_flat): the same flat bytes, starts and lengths as
  the banks built a read at a time, and the same errors;
* make_twolevel_index finds the distinct hashes of the sorted table in
  one pass: darwin_tpu's outputs on a table's edges;
* batches run through run_device_merged against one Genome upload its
  bank once (genome_bank_uploads 1, then 0) and give the records of
  engines built over a fresh upload, and darwin_tpu's.
"""

import dataclasses
import re

import numpy as np
import pytest

from darwin_tpu import pipeline as jpl
from darwin_tpu.dsoft import device as jdev
from darwin_tpu.engine.seqbank import SeqBank as JaxSeqBank
from darwin_tpu.index.genome import Genome as JaxGenome
from darwin_tpu.index.seed_table import SeedTable as JaxSeedTable
from darwin_tpu_torch.coding import seq_to_bytes
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.dsoft import device as dev
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import FastaRecord, parse_fasta, revcomp
from darwin_tpu_torch.pipeline import read_banks, run_device_merged
from tests._torch_threads import one_torch_thread  # noqa: F401


def per_read_banks(records):
    """read_banks as it was: a bank built a read at a time."""
    return (SeqBank([seq_to_bytes(r.seq) for r in records]),
            SeqBank([seq_to_bytes(revcomp(r.seq)) for r in records]))


def seeded_reads(seed: int, n: int) -> list[FastaRecord]:
    """n reads of acgtACGTnN, lengths 0-400 (an empty read among
    them)."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"acgtACGTnN", np.uint8)
    lengths = rng.integers(0, 400, size=n)
    lengths[n // 2] = 0
    return [FastaRecord([f"r{i}"],
                        alphabet[rng.integers(0, 10, size=ln)].tobytes()
                        .decode()) for i, ln in enumerate(lengths)]


@pytest.mark.parametrize("reads", [
    seeded_reads(5, 40), seeded_reads(6, 1), [FastaRecord(["e"], "")], [],
    [FastaRecord(["u"], "ACGTNACGT"), FastaRecord(["l"], "acgtnnac")]],
    ids=["40 reads", "one read", "one empty read", "no reads",
         "upper and lower"])
def test_read_banks_equal_the_banks_a_read_at_a_time(reads):
    for got, want in zip(read_banks(reads), per_read_banks(reads)):
        for key in ("flat", "starts", "lengths"):
            g, w = getattr(got, key), getattr(want, key)
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        assert got.flat.flags.writeable


@pytest.mark.parametrize("seqs", [
    ["ACGT", "acgXTQB", "ZZ"], ["", "ACGTU"], ["N-N"], ["ACGT", "aé"]],
    ids=["first bad read", "after an empty read", "a gap", "not ascii"])
def test_read_banks_raise_the_same_error(seqs):
    reads = [FastaRecord([str(i)], s) for i, s in enumerate(seqs)]
    with pytest.raises(ValueError) as want:
        per_read_banks(reads)
    with pytest.raises(type(want.value),
                       match=f"^{re.escape(str(want.value))}$"):
        read_banks(reads)


@pytest.mark.parametrize("hashes", [
    np.array([7], np.uint32),
    np.full(50, 123456, np.uint32),
    np.sort(np.random.default_rng(8).integers(
        2**31 - 2500, 2**31 + 2500, size=3000)).astype(np.uint32),
    np.array([0, 0, 1, 2**32 - 1, 2**32 - 1], np.uint32),
    np.repeat(np.arange(0, 2**32, 2**28, dtype=np.uint64),
              np.arange(1, 17)).astype(np.uint32),
    np.sort(np.random.default_rng(9).integers(
        2**32 - 5000, 2**32, size=3000)).astype(np.uint32)],
    ids=["one hash", "all equal", "across 2^31", "both ends", "wide span",
         "near 2^32"])
def test_twolevel_index_equals_jax_on_a_tables_edges(hashes):
    if hashes[0] >= 2**31:
        # The base rides as int32 in both: a table of k = 16 hashes
        # above 2^31 fails alike.
        for make in (dev.make_twolevel_index, jdev.make_twolevel_index):
            with pytest.raises(OverflowError):
                make(hashes)
        return
    got, want = dev.make_twolevel_index(hashes), \
        jdev.make_twolevel_index(hashes)
    assert got[5] == want[5]
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def guided(data_dir):
    """The guided fixture (a separate three-piece reference) at tile
    64, as test_torch_cli's chunked run takes it, and two batches of
    its reads cut to their first 1500 bases (the CPU engine's time)."""
    d = data_dir / "guided"
    params = dataclasses.replace(Params.from_cfg(d / "params.cfg"),
                                 tile_size=64, tile_overlap=24)
    ref = parse_fasta(d / "ref.fasta")
    reads = [FastaRecord(r.fields, r.seq[:1500])
             for r in parse_fasta(d / "reads.fasta")]
    return params, ref, [reads[:5], reads[5:9]]


def _table(genome, params, cls=SeedTable):
    return cls.build(genome.concat, params.seed_size,
                     params.seed_occurence_multiple, params.bin_size,
                     params.window_size)


def _fields(recs):
    return [tuple(vars(r).values()) for r in recs]


@pytest.mark.parametrize("dsoft", ["host", "device"])
def test_batches_against_a_resident_genome(guided, dsoft):
    params, ref, batches = guided
    kw = dict(same_file=False, batch_size=64, dsoft=dsoft, device="cpu")
    genome = Genome(ref, params.bin_size)
    table = _table(genome, params)
    jgenome = JaxGenome(ref, params.bin_size)
    jtable = _table(jgenome, params, JaxSeedTable)
    uploads = []
    for batch in batches:
        m = {}
        resident, _ = run_device_merged(genome, table, *read_banks(batch),
                                        params, metrics=m, **kw)
        uploads.append(m["genome_bank_uploads"])
        assert m["engine_build_s"] > 0
        # A fresh Genome: its engine uploads the genome's bank anew.
        fresh_genome = Genome(ref, params.bin_size)
        fm = {}
        fresh, _ = run_device_merged(fresh_genome, table,
                                     *read_banks(batch), params,
                                     metrics=fm, **kw)
        assert fm["genome_bank_uploads"] == 1
        want, _ = jpl.run_device_merged(
            jgenome, jtable, *(JaxSeqBank(list(b.flat[s:s + n] for s, n in
                                               zip(b.starts, b.lengths)))
                               for b in per_read_banks(batch)),
            params, same_file=False, batch_size=64, backend="lax",
            dsoft=dsoft)
        assert len(resident) > 0
        assert _fields(resident) == _fields(fresh) == _fields(want)
    assert uploads == [1, 0]
    assert list(genome._device_bank) == ["cpu"]
