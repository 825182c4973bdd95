"""darwin_tpu_torch span fetch against the JAX package's Pallas fetch.

The JAX engine fetches [TP] byte spans from a combined (forward +
reversed) bank addressed by split (row, byte) pairs, then masks bytes
past each tile's length (device_batch.py:339-346).  The port reads the
flat forward bank with int64 offsets and pads in the same pass.  Both
must give the same [B, T] tiles, for forward and backward reads and for
padding slots whose offsets lie outside the bank.
"""

import numpy as np
import pytest
import torch

from darwin_tpu.ops.tile_fetch import ROW, build_combined_bank, fetch_tiles
from darwin_tpu_torch.ops import tile_fetch as tf
from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF
from darwin_tpu_torch.ops.tile_fetch import fetch_tiles_torch
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
