"""darwin_tpu_torch.ops.pack against the JAX package's word packers.

pack_dir_words and pack_dir_words6 must equal
darwin_tpu.ops.traceback's on the same bytes; plane2_words must equal
its definition cell by cell (the probe's own kernel holds it in
tests/test_torch_plane2.py).  Integers throughout: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from darwin_tpu.ops.traceback import pack_dir_words as jax_pack
from darwin_tpu.ops.traceback import pack_dir_words6 as jax_pack6
from darwin_tpu_torch.ops import pack
from tests._torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(2, 4, 5), (3, 24, 25), (2, 40, 128), (1, 7, 3)]


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 32, size=shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["pack_dir_words", "pack_dir_words6"])
def test_packers_match_jax(shape, name):
    d = _bytes(shape, sum(shape))
    want = np.asarray({"pack_dir_words": jax_pack,
                       "pack_dir_words6": jax_pack6}[name](d))
    got = getattr(pack, name)(torch.from_numpy(d)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES + [(2, 3, 2)])
def test_plane2_words_definition(shape):
    d = _bytes(shape, 7 + sum(shape))
    B, T, C = shape

    def D(b, r, c):
        return int(d[b, r, c]) if 0 <= r < T and 0 <= c < C else 0

    want = np.array([[[D(b, r - 4, c - 2) | D(b, r - 5, c - 2) << 5
                       | D(b, r - 6, c - 3) << 10 for c in range(C)]
                      for r in range(T)] for b in range(B)],
                    dtype=np.int32).reshape(shape)
    np.testing.assert_array_equal(
        pack.plane2_words(torch.from_numpy(d)).numpy(), want)
