"""darwin_tpu_torch span fetch against the JAX package's Pallas fetch.

The JAX engine fetches [TP] byte spans from a combined (forward +
reversed) bank addressed by split (row, byte) pairs, then masks bytes
past each tile's length (device_batch.py:339-346).  The port reads the
flat forward bank with int64 offsets and pads in the same pass.  Both
must give the same [B, T] tiles, for forward and backward reads and for
padding slots whose offsets lie outside the bank.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from darwin_tpu.ops.tile_fetch import ROW, build_combined_bank, fetch_tiles
from darwin_tpu_torch.engine.device_batch import device_banks
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.io.fasta import parse_fasta
from darwin_tpu_torch.ops import tile_fetch as tf
from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF
from darwin_tpu_torch.ops.tile_fetch import (fetch_tile_pair_torch,
                                             fetch_tiles_torch)
from darwin_tpu_torch.pipeline import read_banks
from tests._torch_threads import one_torch_thread  # noqa: F401


def _jax_tiles(flat, pad, start, length, backward, T):
    """The JAX engine's fetch + mask for spans [start, start+length) of
    flat (backward spans read back to front from the reversed copy)."""
    bank, GP = build_combined_bank(flat, pad_byte=pad)
    eff = np.where(backward, 2 * GP - start - length, start).astype(np.int64)
    out = np.asarray(fetch_tiles(
        np.floor_divide(eff, ROW).astype(np.int32),
        np.mod(eff, ROW).astype(np.int32), bank, T=T,
        n_rows=bank.shape[0], interpret=True))[:, :T]
    k = np.arange(T)[None, :]
    return np.where(k < length[:, None], out, np.uint8(pad))


def _torch_tiles(flat, pad, start, length, backward, T):
    return fetch_tiles_torch(
        torch.from_numpy(flat), torch.from_numpy(start.astype(np.int64)),
        torch.from_numpy(length.astype(np.int32)),
        torch.from_numpy(backward), T=T, pad=pad).numpy()


@pytest.mark.parametrize("T,pad", [(64, PAD_REF), (320, PAD_QUERY)])
def test_fetch_matches_jax_mixed_directions(T, pad):
    rng = np.random.default_rng(T)
    flat = rng.integers(65, 91, size=10_000).astype(np.uint8)
    B = 64
    length = rng.integers(0, T + 1, size=B)
    length[:2] = [T, 0]
    start = rng.integers(0, len(flat) - T, size=B)
    backward = rng.random(B) < 0.5
    got = _torch_tiles(flat, pad, start, length, backward, T)
    want = _jax_tiles(flat, pad, start, length, backward, T)
    np.testing.assert_array_equal(got, want)
    b = int(np.flatnonzero(backward & (length > 0))[0])
    s, L = start[b], length[b]
    np.testing.assert_array_equal(got[b, :L], flat[s:s + L][::-1])


def test_fetch_clips_padding_slots():
    """Padding slots carry arbitrary offsets with length 0: both paths
    give all-pad tiles.  Live spans that run off either end of the bank
    read the clipped end bytes instead of faulting."""
    rng = np.random.default_rng(1)
    flat = rng.integers(65, 91, size=2048).astype(np.uint8)
    T = 64
    start = np.array([0, -50, 10 ** 9, 5, 2040, -3, 7, 100])
    length = np.array([0, 0, 0, 0, 20, 10, 64, 64])
    backward = np.array([0, 1, 0, 1, 0, 1, 1, 0], dtype=bool)
    got = _torch_tiles(flat, PAD_REF, start, length, backward, T)
    want = _jax_tiles(flat, PAD_REF, np.maximum(start, 0), length,
                      backward, T)
    np.testing.assert_array_equal(got[:4], want[:4])
    np.testing.assert_array_equal(got[6:], want[6:])
    assert (got[:4] == PAD_REF).all()
    np.testing.assert_array_equal(got[4, :8], flat[2040:2048])
    np.testing.assert_array_equal(got[4, 8:20], flat[-1])
    np.testing.assert_array_equal(got[5, :7], flat[6::-1])
    np.testing.assert_array_equal(got[5, 7:10], flat[0])


def test_fetch_dispatch():
    bank = torch.arange(100, dtype=torch.uint8)
    start = torch.tensor([3, 50], dtype=torch.int64)
    length = torch.tensor([4, 2], dtype=torch.int32)
    back = torch.tensor([False, True])
    got = tf.fetch_tiles(bank, start, length, back, T=6, pad=PAD_REF)
    assert got.tolist() == [[3, 4, 5, 6, 1, 1], [51, 50, 1, 1, 1, 1]]
    with pytest.raises(ValueError):
        tf.fetch_tiles(*(x.to("meta") for x in (bank, start, length, back)),
                       T=6, pad=PAD_REF)


def _pair_spans(rng, n, T, B):
    """Mixed-direction spans of a bank of n bytes: lanes 0-3 padding
    slots (length 0, offsets outside the bank), lanes 4-5 live spans
    running off the bank's start and end, the rest inside it."""
    start = rng.integers(0, n - T, size=B)
    length = rng.integers(0, T + 1, size=B)
    start[:6] = [-50, 10 ** 9, n, -(10 ** 12), -3, n - 5]
    length[:6] = [0, 0, 0, 0, T, T]
    return start, length


@pytest.mark.parametrize("T", [64, 320, 376])
def test_fetch_tile_pair_matches_two_jax_fetches(T):
    """fetch_tile_pair's plain version against two calls of the JAX
    fetch (one a bank, the slot's backward flag shared): padding slots
    are all pad, in-bank spans equal the JAX tiles, spans off the bank's
    ends read its clipped end bytes."""
    rng = np.random.default_rng(T + 7)
    B = 48
    gflat = rng.integers(65, 91, size=5_000).astype(np.uint8)
    qflat = rng.integers(65, 91, size=3_001).astype(np.uint8)
    g_start, rl = _pair_spans(rng, len(gflat), T, B)
    q_start, ql = _pair_spans(rng, len(qflat), T, B)
    backward = rng.random(B) < 0.5
    backward[4:6] = [True, False]
    ref_t, query_t = (x.numpy() for x in fetch_tile_pair_torch(
        torch.from_numpy(gflat), torch.from_numpy(qflat),
        torch.from_numpy(g_start), torch.from_numpy(q_start),
        torch.from_numpy(rl.astype(np.int32)),
        torch.from_numpy(ql.astype(np.int32)), torch.from_numpy(backward),
        T=T, pad_ref=PAD_REF, pad_query=PAD_QUERY))
    for got, flat, pad, start, length in (
            (ref_t, gflat, PAD_REF, g_start, rl),
            (query_t, qflat, PAD_QUERY, q_start, ql)):
        want = _jax_tiles(flat, pad, np.clip(start, 0, len(flat) - T),
                          length, backward, T)
        np.testing.assert_array_equal(got[:4], want[:4])
        np.testing.assert_array_equal(got[6:], want[6:])
        assert (got[:4] == pad).all()
        np.testing.assert_array_equal(got[4, :T - 3], flat[:T - 3][::-1])
        np.testing.assert_array_equal(got[4, T - 3:], flat[0])
        np.testing.assert_array_equal(got[5, :5], flat[-5:])
        np.testing.assert_array_equal(got[5, 5:], flat[-1])


def test_fetch_tile_pair_dispatch():
    gbank = torch.arange(100, dtype=torch.uint8)
    qbank = torch.arange(100, 140, dtype=torch.uint8)
    g_start = torch.tensor([3, 50], dtype=torch.int64)
    q_start = torch.tensor([30, 0], dtype=torch.int64)
    rl = torch.tensor([4, 2], dtype=torch.int32)
    ql = torch.tensor([2, 3], dtype=torch.int32)
    back = torch.tensor([False, True])
    ref_t, query_t = tf.fetch_tile_pair(gbank, qbank, g_start, q_start, rl,
                                        ql, back, T=6, pad_ref=PAD_REF,
                                        pad_query=PAD_QUERY)
    assert ref_t.tolist() == [[3, 4, 5, 6, 1, 1], [51, 50, 1, 1, 1, 1]]
    assert query_t.tolist() == [[130, 131, 2, 2, 2, 2],
                                [102, 101, 100, 2, 2, 2]]
    with pytest.raises(ValueError):
        tf.fetch_tile_pair(*(x.to("meta") for x in (
            gbank, qbank, g_start, q_start, rl, ql, back)), T=6,
            pad_ref=PAD_REF, pad_query=PAD_QUERY)


@pytest.mark.parametrize("fixture", ["tiny", "guided"])
def test_device_banks_pad_storage_not_contents(fixture):
    """device_banks' tensors hold the flat bytes and one pad byte, as
    before; only their storage is rounded up to 16 bytes (pad bytes),
    for the span fetch's aligned 16-byte loads."""
    d = Path(__file__).resolve().parent / "data" / fixture
    reads = parse_fasta(d / "reads.fasta")
    ref = parse_fasta(d / "ref.fasta") if (d / "ref.fasta").exists() \
        else reads
    genome = Genome(ref, 128)
    fwd, _ = read_banks(reads)
    for bank, flat, pad in zip(device_banks(genome, fwd, "cpu"),
                               (genome.concat, fwd.flat),
                               (PAD_REF, PAD_QUERY)):
        assert bank.shape == (len(flat) + 1,) and bank.dtype == torch.uint8
        np.testing.assert_array_equal(bank[:-1].numpy(), flat)
        assert int(bank[-1]) == pad
        size = bank.untyped_storage().nbytes()
        assert size % 16 == 0 and 0 <= size - bank.shape[0] < 16
        assert bank.storage_offset() == 0
        full = torch.empty(size, dtype=torch.uint8)
        full.untyped_storage().copy_(bank.untyped_storage())
        assert (full[bank.shape[0]:] == pad).all()
