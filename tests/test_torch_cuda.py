"""darwin_tpu_torch's CUDA kernels on the card, against their plain
PyTorch versions (which the other test_torch_* files hold against the
JAX package).  Every test here needs a CUDA device and skips without
one.  The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py -q

All outputs are integers: the tolerance is 0.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from darwin_tpu.config import Params
from darwin_tpu.io.fasta import parse_fasta
from darwin_tpu_torch.engine.device_batch import DeviceGactEngine
from darwin_tpu_torch.ops import dp, tile_fetch, traceback
from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF
from darwin_tpu_torch.ops.reference_dp import align_tiles_torch
from darwin_tpu_torch.ops.tile_fetch import fetch_tiles_torch
from darwin_tpu_torch.ops.traceback import traceback_torch
from darwin_tpu_torch.pipeline import run_pipeline

pytestmark = pytest.mark.cuda
TINY = Path(__file__).resolve().parent / "data" / "tiny"
SCORINGS = [(1, -1, -1, -1), (2, -3, -4, -2), (3, -1, -2, -1),
            (2, 1, -3, -1), (2, -1, 1, -2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tiles(seed, B, T, device):
    """Related ACGT tiles (15% substitutions, a shifted copy in every
    fourth lane for gaps), random lengths, padded; lanes 0-2 idle, empty
    ref, empty query."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    src = acgt[rng.integers(0, 4, size=(B, T + 8))]
    ref = src[:, :T].copy()
    query = src[:, :T].copy()
    query[::4] = src[::4, 8:]
    mut = rng.random((B, T)) < 0.15
    query[mut] = acgt[rng.integers(0, 4, size=int(mut.sum()))]
    rlen = rng.integers(1, T + 1, size=B).astype(np.int32)
    qlen = rng.integers(1, T + 1, size=B).astype(np.int32)
    rlen[0] = qlen[0] = rlen[1] = qlen[2] = 0
    k = np.arange(T)[None, :]
    ref[k >= rlen[:, None]] = PAD_REF
    query[k >= qlen[:, None]] = PAD_QUERY
    first = rng.random(B) < 0.5
    return [torch.from_numpy(x).to(device)
            for x in (ref, query, rlen, qlen, first)]


@pytest.mark.parametrize("T,et", [(64, 40), (320, 200), (376, 256)])
def test_dp_and_walker_kernels_match_plain(cuda, T, et):
    ref, query, rlen, qlen, first = _tiles(T, 64, T, cuda)
    for sc in SCORINGS:
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
        n = dp.align_tiles.launches
        got = dp.align_tiles(ref, query, rlen, qlen, **kw)
        assert dp.align_tiles.launches == n + 1
        want = align_tiles_torch(ref, query, rlen, qlen, **kw)
        for key in want:
            assert torch.equal(got[key], want[key]), (sc, key)
        args = (got["dir"], rlen, qlen, first, got["max_i"], got["max_j"])
        n = traceback.traceback.launches
        g = traceback.traceback(*args, early_terminate=et)
        assert traceback.traceback.launches == n + 1
        w = traceback_torch(*args, early_terminate=et)
        for a, b in zip(g, w):
            assert torch.equal(a, b), sc


@pytest.mark.parametrize("T", [64, 320])
def test_fetch_kernel_matches_plain(cuda, T):
    rng = np.random.default_rng(T)
    bank = torch.from_numpy(rng.integers(65, 91, size=100_000).astype(
        np.uint8)).to(cuda)
    n_bank = bank.shape[0]
    B = 64
    start = rng.integers(-T, n_bank + T, size=B)
    start[:2] = [-10 ** 9, 10 ** 12]
    args = (bank, torch.from_numpy(start).to(cuda),
            torch.from_numpy(rng.integers(0, T + 1, size=B).astype(
                np.int32)).to(cuda),
            torch.from_numpy(rng.random(B) < 0.5).to(cuda))
    n = tile_fetch.fetch_tiles.launches
    got = tile_fetch.fetch_tiles(*args, T=T, pad=PAD_QUERY)
    assert tile_fetch.fetch_tiles.launches == n + 1
    assert torch.equal(got, fetch_tiles_torch(*args, T=T, pad=PAD_QUERY))


def test_wrappers_reject_bad_arguments(cuda):
    ref, query, rlen, qlen, _ = _tiles(0, 8, 32, cuda)
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    with pytest.raises(TypeError):
        dp.align_tiles(ref, query, rlen.long(), qlen, **kw)
    with pytest.raises(ValueError):
        dp.align_tiles(ref, query, rlen.cpu(), qlen, **kw)
    with pytest.raises(ValueError):
        dp.align_tiles(ref.t().contiguous().t(), query, rlen, qlen, **kw)
    big = torch.zeros((2, 1024), dtype=torch.uint8, device=cuda)
    n2 = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dp.align_tiles(big, big, n2, n2, **kw)
    with pytest.raises(ValueError):
        tile_fetch.fetch_tiles(torch.zeros(0, dtype=torch.uint8,
                                           device=cuda),
                               n2.long(), n2, n2.bool(), T=8, pad=1)


def test_pipeline_on_card_matches_reference_with_one_sync_per_iteration(
        cuda):
    """tiny end to end on the card: the reference binary's records, and
    the engine loop waits for the device once per iteration (its
    termination check), plus its set-up copies and the final download."""
    params = Params.from_cfg(TINY / "params.cfg")
    reads = parse_fasta(TINY / "reads.fasta")
    res = run_pipeline(reads, reads, params, True, batch_size=4,
                       device=cuda)
    assert set(res.records) == set((TINY / "out.darwin").read_text()
                                   .splitlines())

    from darwin_tpu.index.genome import Genome
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu_torch.engine.batch import GactCalls
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.pipeline import collect_calls, read_banks

    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    merged = SeqBank.concat(*read_banks(reads))
    calls = collect_calls(table, genome, merged, params)
    eng = DeviceGactEngine(
        genome, merged, tile_size=params.tile_size,
        early_terminate=params.early_terminate,
        first_tile_score_threshold=params.first_tile_score_threshold,
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_extend=params.gap_extend,
        same_file=True, batch_size=4, device=cuda)
    R = len(reads)
    calls_r = GactCalls(calls.ref_id, calls.query_id % R, calls.ref_pos,
                        calls.query_pos)
    comp = (calls.query_id >= R).astype(np.int32)
    eng.finish(eng.run_async(calls_r, comp, calls.query_id))  # warm-up
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            recs = eng.finish(eng.run_async(calls_r, comp, calls.query_id))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    assert len(recs) > 0 and eng.last_iters >= 100
    # Besides the per-iteration check: 10 set-up uploads of the call
    # tables and 3 downloads in finish().
    assert eng.last_iters <= syncs <= eng.last_iters + 20, syncs
