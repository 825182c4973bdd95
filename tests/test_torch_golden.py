"""darwin_tpu_torch.golden (the port's copy of the golden scalar spec)
against darwin_tpu.golden, on every fixture, and golden_pipeline against
the reference binary's out.darwin.

* GoldenSeedTable (hashes, positions, kmer_max_occurence) and
  dsoft_scalar on each fixture's reads;
* align_with_bt on tiles cut from each fixture's reads, forward and
  reversed, first and anchored, under the fixture's scoring;
* gact_scalar on the fixture's first D-SOFT candidates at a small tile
  (the scalar DP is Python: T = 48 keeps it short), affine_rescore and
  format_record;
* golden_pipeline on tiny equals out.darwin (and darwin_tpu's).

Every output is an integer or a string: the comparisons are exact.
"""

from pathlib import Path

import numpy as np
import pytest

from darwin_tpu.config import Params as JaxParams
from darwin_tpu.golden import align as jalign
from darwin_tpu.golden import dsoft as jdsoft
from darwin_tpu.golden import gact as jgact
from darwin_tpu.golden.pipeline import golden_pipeline as jax_golden_pipeline
from darwin_tpu.io.fasta import parse_fasta as jax_parse_fasta
from darwin_tpu_torch.coding import seq_to_bytes
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.golden import align, dsoft, gact
from darwin_tpu_torch.golden.pipeline import golden_pipeline
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.io.fasta import parse_fasta

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
FIXTURES = sorted(p.parent.name for p in DATA.glob("*/out.darwin"))


def _load(name):
    d = DATA / name
    params = Params.from_cfg(d / "params.cfg")
    reads = parse_fasta(d / "reads.fasta", native=False)
    ref = (parse_fasta(d / "ref.fasta", native=False)
           if (d / "ref.fasta").exists() else reads)
    return params, ref, reads


def _tables(params, ref):
    genome = Genome(ref, params.bin_size)
    args = (genome.concat, params.seed_size, params.seed_occurence_multiple,
            params.bin_size, params.window_size)
    return genome, dsoft.GoldenSeedTable(*args), jdsoft.GoldenSeedTable(*args)


@pytest.mark.parametrize("name", FIXTURES)
def test_seed_table_and_dsoft_scalar_equal_jax(name):
    params, ref, reads = _load(name)
    _, gt, jt = _tables(params, ref)
    np.testing.assert_array_equal(gt.hashes, jt.hashes)
    np.testing.assert_array_equal(gt.pos_table, jt.pos_table)
    assert (gt.k, gt.w, gt.bin_size, gt.ref_size, gt.kmer_max_occurence) \
        == (jt.k, jt.w, jt.bin_size, jt.ref_size, jt.kmer_max_occurence)
    n = 0
    for r in reads[:6]:
        b = seq_to_bytes(r.seq)
        got = dsoft.dsoft_scalar(gt, b, params.num_seeds, params.threshold,
                                 params.max_candidates)
        assert got == jdsoft.dsoft_scalar(jt, b, params.num_seeds,
                                          params.threshold,
                                          params.max_candidates)
        n += len(got)
    assert n > 0


@pytest.mark.parametrize("name", FIXTURES)
def test_align_with_bt_equals_jax(name):
    params, _, reads = _load(name)
    rng = np.random.default_rng(len(name))
    sc = (params.match, params.mismatch, params.gap_open, params.gap_extend)
    for _ in range(3):
        a, b = (seq_to_bytes(reads[int(rng.integers(len(reads)))].seq)
                for _ in range(2))
        s = int(rng.integers(0, max(1, min(len(a), len(b)) - 40)))
        ref, query = a[s:s + int(rng.integers(1, 40))], b[s:s + 36]
        for reverse in (False, True):
            for first in (False, True):
                args = (ref, query, *sc, len(query), len(ref), reverse, first,
                        params.early_terminate)
                assert align.align_with_bt(*args) == \
                    jalign.align_with_bt(*args)
    assert (align.Z, align.D, align.I, align.M) == (0, 1, 2, 3)


@pytest.mark.parametrize("name", FIXTURES)
def test_gact_scalar_equals_jax(name):
    params, ref, reads = _load(name)
    genome, gt, _ = _tables(params, ref)
    sc = (params.match, params.mismatch, params.gap_open, params.gap_extend)
    calls = 0
    for r in reads[:3]:
        b = seq_to_bytes(r.seq)
        for hit, off in dsoft.dsoft_scalar(gt, b, params.num_seeds,
                                           params.threshold,
                                           params.max_candidates)[:1]:
            chr_id, local = genome.decode_hits([hit])
            piece, local = genome.piece_bytes[int(chr_id[0])], int(local[0])
            # 150 bases each way of the anchor, so that the extension
            # ends within a few tiles.
            rs, qs = max(0, local - 150), max(0, off - 150)
            args = (piece[rs:local + 150], b[qs:off + 150], 48, 16,
                    local - rs, off - qs, params.first_tile_score_threshold,
                    *sc)
            got = gact.gact_scalar(*args)
            assert got == jgact.gact_scalar(*args)
            calls += 1
    assert calls > 0
    aligned = ([65, 67, gact.GAP, 71, 84], [65, 65, 67, gact.GAP, 84])
    assert gact.affine_rescore(*aligned, *sc) == \
        jgact.affine_rescore(*aligned, *sc)
    assert gact.SCORE_THRESHOLD == jgact.SCORE_THRESHOLD
    rec = ("chr1", "r7", 0, 120, 5, 130, 97, True)
    assert gact.format_record(*rec) == jgact.format_record(*rec)


def test_golden_pipeline_equals_out_darwin_and_jax():
    d = DATA / "tiny"
    params = Params.from_cfg(d / "params.cfg")
    reads = parse_fasta(d / "reads.fasta")
    got = golden_pipeline(reads, reads, params, same_file=True)
    want = set((d / "out.darwin").read_text().splitlines())
    assert set(got) == want
    jreads = jax_parse_fasta(d / "reads.fasta")
    assert got == jax_golden_pipeline(
        jreads, jreads, JaxParams.from_cfg(d / "params.cfg"), same_file=True)
