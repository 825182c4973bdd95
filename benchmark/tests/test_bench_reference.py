"""The plain reference against the reference binary's own record sets:
tests/data/<fixture>/out.darwin, read as files."""

import os
from pathlib import Path

import pytest

from benchmark.reference import seeds
from benchmark.reference.overlap import reference_records
from benchmark.reference.seqio import read_fasta, read_params

DATA = Path(__file__).resolve().parents[2] / "tests" / "data"
FIXTURES = ["tiny", "small", "guided", "twofile", "noisy", "nbase", "lcase",
            "hierror", "scoring", "dsoftp", "seedcap", "tpucfg"]


@pytest.mark.parametrize("fixture", FIXTURES)
def test_reference_gives_the_binarys_records(fixture):
    d = DATA / fixture
    p = read_params(d / "params.cfg")
    reads = read_fasta(d / "reads.fasta")
    two = os.path.exists(d / "ref.fasta")
    ref = read_fasta(d / "ref.fasta") if two else reads
    got = reference_records(ref, reads, p, same_file=not two,
                            read_ids=range(len(reads)), device="cpu")
    want = set((d / "out.darwin").read_text().splitlines())
    assert set(got) == want


def test_a_sample_of_reads_gives_their_lines_of_the_whole_set():
    d = DATA / "tiny"
    p = read_params(d / "params.cfg")
    reads = read_fasta(d / "reads.fasta")
    want = set((d / "out.darwin").read_text().splitlines())
    ids = [1, 4]
    names = {reads[i][0] for i in ids}
    got = reference_records(reads, reads, p, same_file=True, read_ids=ids,
                            device="cpu")
    assert set(got) == {r for r in want
                        if r.split("query_id: ")[1].split(",")[0] in names}


def test_wang_hash_and_minimizers_on_a_hand_case():
    import torch
    # k = 4: AAAA has code 0; the masked hash of 0 is what the
    # uint32 arithmetic gives masked to 8 bits.
    m = (1 << 8) - 1
    key = 0
    key = (~key + (key << 21)) & 0xFFFFFFFF & m
    key ^= key >> 24
    key = (key + (key << 3) + (key << 8)) & m
    key ^= key >> 14
    key = (key + (key << 2) + (key << 4)) & m
    key ^= key >> 28
    key = (key + (key << 31)) & m
    assert int(seeds.wang_hash(torch.tensor([0]), 4)[0]) == key
    # A 40-base query: scan positions w-1 .. 16*3-k-w-1, padded with A.
    seq = torch.tensor(list(b"ACGTTGCAACGTAGCTAGCTAGGATCCATGCAAGCTTGCA"),
                       dtype=torch.uint8)
    p, h = seeds.minimizers(seq, 5, 3, reference=False)
    assert int(p.min()) >= 2 and int(p.max()) < 48 - 5 - 3
    assert (torch.diff(p) > 0).all()


def test_the_graph_round_equals_the_eager_round():
    """tile_round without its early stops (the work a CUDA graph
    replays), on random related tiles, equals the eager round."""
    import torch
    from benchmark.reference.gact import tile_round
    g = torch.Generator().manual_seed(0)
    n, T = 24, 64
    p = dict(read_params(DATA / "tiny" / "params.cfg"))
    base = torch.randint(0, 4, (n, T), generator=g)
    noise = torch.randint(0, 4, (n, T), generator=g)
    qry = torch.where(torch.rand(n, T, generator=g) < 0.15, noise, base)
    rtl = torch.randint(1, T + 1, (n,), generator=g)
    qtl = torch.randint(1, T + 1, (n,), generator=g)
    cols = torch.arange(T)
    qry = torch.where(cols < qtl[:, None], qry, -1).to(torch.int16)
    first = torch.rand(n, generator=g) < 0.5
    a = tile_round(base.to(torch.int16), qry, rtl, qtl, first, p)
    b = tile_round(base.to(torch.int16), qry, rtl, qtl, first, p,
                   eager=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("chunk", [1, 7, 64, 1 << 26])
@pytest.mark.parametrize("kind", ["random", "homopolymer", "repeats"])
def test_the_reference_scan_by_chunks_equals_the_whole_scan(kind, chunk):
    """The seed index scans the reference a chunk at a time; a window
    minimum's run carries across chunks (a homopolymer holds one run).
    The whole scan is one chunk, held to out.darwin above."""
    import numpy as np
    import torch
    g = np.random.default_rng(11)
    for n in (0, 17, 31, 1000, 4099):
        if kind == "random":
            seq = g.choice(np.frombuffer(b"ACGTN", np.uint8), n)
        elif kind == "homopolymer":
            seq = np.full(n, ord("A"), np.uint8)
        else:
            seq = np.where(g.random(n) < 0.7, ord("A"), g.choice(
                np.frombuffer(b"ACGT", np.uint8), n)).astype(np.uint8)
        t = torch.from_numpy(seq)
        for k, w in ((14, 4), (4, 1), (12, 8)):
            p, h = seeds.minimizers(t, k, w, reference=True)
            parts = list(seeds.minimizer_chunks(t, k, w, reference=True,
                                                chunk=chunk))
            assert torch.equal(torch.cat([p[:0]] + [a for a, _ in parts]), p)
            assert torch.equal(torch.cat([h[:0]] + [b for _, b in parts]), h)
