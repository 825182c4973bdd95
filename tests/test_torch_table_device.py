"""The seed table's device build (darwin_tpu_torch/index/table_device.py)
on the CPU: its plain versions (the scan, anchor and emit rule of
csrc/seed_table.cu's kernels, and their 8-bit radix passes) give the
hashes and positions of the native build as SeedTable.build filters and
splits them, and of darwin_tpu's ref_minimizers, bit for bit, over k and
w, lengths around multiples of 16 and of a kernel tile and the native
scan's single-thread threshold, homopolymers, an N-padded multi-read
genome and a first window whose minimum is 0.  Also SeedTable.build's
route: the kernels on a CUDA device, the native build off it."""

import numpy as np
import pytest
import torch

from darwin_tpu.coding import ref_minimizers as jax_ref_minimizers
from darwin_tpu_torch import native
from darwin_tpu_torch.coding import hash32
from darwin_tpu_torch.index import table_device as td
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import FastaRecord
from tests._torch_threads import one_torch_thread  # noqa: F401

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# The native library scans in one thread below 2^16 positions.
ONE_THREAD = 1 << 16


def _random(seed: int, n: int, alphabet: bytes = b"ACGT") -> np.ndarray:
    a = np.frombuffer(alphabet, dtype=np.uint8)
    return a[np.random.default_rng(seed).integers(0, len(a), n)].copy()


def _homopolymer(seed: int, n: int) -> np.ndarray:
    """Random bases around a run of one base longer than two tiles."""
    g = _random(seed, n)
    g[n // 8:n // 8 + 2 * td.TILE + 77] = ord("A")
    return g


def _padded_reads(seed: int, n: int) -> np.ndarray:
    """A Genome of reads of 200-3000 bases (some lowercase, some with N),
    each padded with N to a multiple of 64, and one N gap of 9000 bases
    in a read: runs of one minimum across tiles."""
    rng = np.random.default_rng(seed)
    recs, total = [], 0
    while total < n:
        r = _random(seed + len(recs), int(rng.integers(200, 3000)),
                    b"ACGTACGTACGTacgtN")
        if len(recs) == 2:
            r = np.concatenate([r, np.full(9000, ord("N"), np.uint8), r])
        recs.append(FastaRecord([f"r{len(recs)}"], r.tobytes().decode()))
        total += len(r)
    return Genome(recs, 64).concat


def _zero_first(seed: int, n: int, k: int) -> np.ndarray:
    """Random bases whose first k-mer hashes to 0, so the first window's
    minimum is 0 and the scan starts in the virtual run."""
    keys = np.arange(1 << (2 * k), dtype=np.uint64)
    key = int(np.flatnonzero(hash32(keys.astype(np.uint32), k) == 0)[0])
    g = _random(seed, n)
    g[:k] = ACGT[[(key >> (2 * i)) & 3 for i in range(k)]]
    return g


def _cases():
    out = []
    for k, w in [(14, 4), (12, 3), (15, 14), (15, 1), (5, 2), (4, 1),
                 (13, 8), (8, 7)]:
        for n in (0, 1, k + w - 1, 31, 32, 33, 4111, ONE_THREAD + 37):
            out.append(pytest.param("random", n, k, w,
                                    id=f"random-{n}-k{k}-w{w}"))
    for n in (ONE_THREAD - 1, ONE_THREAD, ONE_THREAD + 16 + 14 + 4 - 1):
        out.append(pytest.param("random", n, 14, 4, id=f"random-{n}-k14-w4"))
    for kind, n, k, w in [("homopolymer", 40000, 14, 4),
                          ("homopolymer", 40000, 5, 1),
                          ("padded_reads", 90000, 14, 4),
                          ("padded_reads", 90000, 9, 3),
                          ("zero_first", 9000, 11, 5),
                          ("zero_first", 9000, 10, 1)]:
        out.append(pytest.param(kind, n, k, w, id=f"{kind}-{n}-k{k}-w{w}"))
    return out


def _genome(kind: str, n: int, k: int) -> np.ndarray:
    if kind == "random":
        return _random(n + k, n)
    if kind == "homopolymer":
        return _homopolymer(k, n)
    if kind == "padded_reads":
        return _padded_reads(k, n)
    return _zero_first(k, n, k)


def _split(keys: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """SeedTable.build's filter and split of sorted keys."""
    keys = keys[(keys & np.uint64(0xFFFFFFFF)) < n]
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.mark.parametrize("kind,n,k,w", _cases())
def test_plain_build_equals_native_and_jax(kind, n, k, w):
    g = _genome(kind, n, k)
    b = torch.from_numpy(g)
    scan_h, scan_p = td.minimizer_keys(b, k, w)
    h, p = td.sort_keys(scan_h, scan_p, k)
    assert h.dtype == p.dtype == torch.uint32
    h, p = h.numpy(), p.numpy()
    want_h, want_p = _split(native.build_table_keys(g, k, w, num_threads=4),
                            len(g))
    np.testing.assert_array_equal(h, want_h)
    np.testing.assert_array_equal(p, want_p)
    jax_h, jax_p = _split(np.sort(jax_ref_minimizers(g, k, w)), len(g))
    np.testing.assert_array_equal(h, jax_h)
    np.testing.assert_array_equal(p, jax_p)
    # The scan alone is in position order, the sort's input.
    assert (np.diff(scan_p.numpy().astype(np.int64)) > 0).all()


@pytest.mark.parametrize("as_str", [False, True])
def test_build_on_a_cuda_device_takes_the_kernels(monkeypatch, as_str):
    """With device="cuda", SeedTable.build hands the sequence's bytes
    (from an array or a string) to table_arrays, here faked by the plain
    versions on the CPU; the table is the native build's."""
    g = _padded_reads(3, 20000)
    calls = []

    def fake(seq, k, w, device):
        calls.append((seq, device))
        b = torch.from_numpy(seq.copy())
        h, p = td.sort_keys(*td.minimizer_keys(b, k, w), k)
        return h.numpy(), p.numpy()

    monkeypatch.setattr(td, "table_arrays", fake)
    ref = g.tobytes().decode() if as_str else g
    got = SeedTable.build(ref, 14, 32, 64, 4, device="cuda")
    want = SeedTable.build(g, 14, 32, 64, 4)
    assert len(calls) == 1 and calls[0][1] == "cuda"
    np.testing.assert_array_equal(calls[0][0], g)
    np.testing.assert_array_equal(got.hashes, want.hashes)
    np.testing.assert_array_equal(got.pos, want.pos)
    assert (got.ref_size, got.kmer_max_occurence) == (
        want.ref_size, want.kmer_max_occurence)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_build_off_the_card_is_the_native_build(device):
    g = _random(5, 30000)
    t = SeedTable.build(g, 14, 32, 64, 4, device=device)
    want_h, want_p = _split(native.build_table_keys(g, 14, 4), len(g))
    np.testing.assert_array_equal(t.hashes, want_h)
    np.testing.assert_array_equal(t.pos, want_p)


def test_wrappers_count_no_launch_on_the_cpu():
    n0, s0 = td.minimizer_keys.launches, td.sort_keys.launches
    td.sort_keys(*td.minimizer_keys(torch.from_numpy(_random(1, 500)), 14,
                                    4), 14)
    assert (td.minimizer_keys.launches, td.sort_keys.launches) == (n0, s0)


@pytest.mark.parametrize("k,w", [(3, 2), (16, 4), (14, 14), (14, 0)])
def test_wrappers_refuse_k_and_w_out_of_range(k, w):
    with pytest.raises(ValueError):
        td.minimizer_keys(torch.from_numpy(_random(1, 100)), k, w)
