"""Tile sizes past the one-warp DP, up to the reference's 2048, on the
CPU.

* the plain DP against align_tiles_jax at T = 2048 in every format
  (the word formats through the port's packers);
* the split path's dispatch: strips_for and check_strips (the path,
  the warps a tile and the columns a lane) at the edges of each path (the kernel itself runs only on the card:
  tests/test_torch_cuda.py);
* the port's CPU pipeline at tile_size = 1024 against darwin_tpu's
  run_pipeline (lax backend) on a datagen slice whose reads take several
  tiles, set-exact, under both engines;
* tests/data/ecoli_shape_t1024 and ecoli_shape_t2048: their dataset
  digest, made by the port's generator from the E.coli recipe.

All outputs are integers or record strings: the tolerance is 0.
"""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from darwin_tpu.config import Params as JaxParams
from darwin_tpu.io.fasta import FastaRecord as JaxRecord
from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu.pipeline import run_pipeline as jax_run_pipeline
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.eval.datagen import sample_reads, synth_genome
from darwin_tpu_torch.io.fasta import FastaRecord
from darwin_tpu_torch.ops import dp
from darwin_tpu_torch.pipeline import run_pipeline
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_dp import GE, GO, MATCH, MISMATCH, make_batch

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
sys.path.insert(0, str(REPO / "tools"))
import torch_scale_test as scale_test  # noqa: E402


def test_plain_dp_at_t2048_equals_jax_in_every_format():
    """B = 2, T = 2048, the kernel's largest tile: the plain DP's bytes
    and stats equal align_tiles_jax's, and each word format equals the
    packer on the JAX bytes."""
    rng = np.random.default_rng(2048)
    B, T = 2, 2048
    ref, query, rlen, qlen = make_batch(rng, B, T)
    kw = dict(match=MATCH, mismatch=MISMATCH, gap_open=GO, gap_extend=GE)
    want = align_tiles_jax(ref, query, rlen, qlen, **kw)
    jdir = torch.from_numpy(np.array(want["dir"]))
    args = [torch.from_numpy(x) for x in (ref, query, rlen, qlen)]
    for fmt, packer in dp.PACKERS.items():
        got = dp.align_tiles(*args, dir_format=fmt, **kw)
        d = got.pop("dir") if fmt == "bytes" else got.pop("dir_words")
        assert torch.equal(d, jdir if packer is None else packer(jdir)), fmt
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                          err_msg=f"{fmt} {k}")


@pytest.mark.parametrize("T,interleave,strips", [
    (1, 1, 1), (1023, 1, 1), (1024, 1, 2), (1536, 1, 3), (1537, 1, 4),
    (2048, 1, 4), (384, 2, 1), (385, 2, 2), (1025, 4, 5), (2048, 4, 8)])
def test_strips_for_picks_the_path(T, interleave, strips):
    """One warp a tile up to ONE_WARP_TILE, then the least number of
    warps whose strips of the widest split width (16 columns a lane, 8
    interleaved) cover T, which check_strips takes: width 0 (dp.cu
    picks the one-warp path's) or the widest."""
    assert dp.strips_for(T, interleave) == strips
    width = dp.check_strips(T, interleave, strips, "test")
    assert width == (0 if strips == 1 else 16 if interleave == 1 else 8)


@pytest.mark.parametrize("T,interleave,strips,width", [
    (1025, 1, 3, 12), (1152, 1, 3, 12), (1153, 1, 3, 16), (700, 1, 2, 12),
    (320, 1, 2, 8), (1023, 1, 8, 8), (2047, 1, 4, 16), (385, 2, 2, 8)])
def test_check_strips_picks_the_least_width(T, interleave, strips, width):
    """The split path's columns a lane: the least width csrc/dp.cu
    instantiates (8, 12, 16; 8 interleaved) whose strips cover T."""
    assert dp.check_strips(T, interleave, strips, "test") == width


@pytest.mark.parametrize("T,interleave,strips,ok", [
    (320, 1, 2, True), (1023, 1, 8, True), (1024, 1, 1, False),
    (1025, 1, 2, False), (2048, 1, 4, True), (2048, 1, 9, False),
    (385, 4, 1, False), (2048, 2, 7, False), (320, 2, 2, True),
    (320, 1, 0, False)])
def test_check_strips_limits(T, interleave, strips, ok):
    """A forced number of warps a tile: 1 only where the one-warp path
    takes T, 2..8 where their strips cover it."""
    if ok:
        dp.check_strips(T, interleave, strips, "test")
    else:
        with pytest.raises(ValueError, match="warps a tile"):
            dp.check_strips(T, interleave, strips, "test")


def test_run_kernel_checks_strips_before_the_device():
    """A CPU tensor never reaches the strips check: run_kernel asks for
    CUDA first, as it does for the warps."""
    args = [torch.zeros((4, 8), dtype=torch.uint8)] * 2 + [
        torch.zeros(4, dtype=torch.int32)] * 2
    with pytest.raises(ValueError, match="CUDA"):
        dp.run_kernel(*args, match=1, mismatch=-1, gap_open=-1,
                      gap_extend=-1, fmt="bytes", interleave=1, what="test",
                      strips=2)


@pytest.fixture(scope="module")
def slice_1024():
    """Six 3.5 kb reads of a 40 kb genome (5% error, half reverse
    complemented): at T = 1024, ET = 904, each overlap takes several
    tiles a direction."""
    rng = np.random.default_rng(1024)
    genome = synth_genome(40_000, rng)
    reads = sample_reads(genome, 6, 3500, rng, error_rate=0.05,
                         rc_fraction=0.5)
    want = jax_run_pipeline(
        [JaxRecord([n], s) for n, s in reads],
        [JaxRecord([n], s) for n, s in reads], JaxParams(tile_size=1024),
        True, batch_size=64, engine="device", backend="lax")
    return reads, set(want.records)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_cpu_pipeline_at_tile_1024_equals_darwin_tpu(slice_1024, engine):
    reads, want = slice_1024
    recs = [FastaRecord([n], s) for n, s in reads]
    got = run_pipeline(recs, recs, Params(tile_size=1024), True,
                       batch_size=64, engine=engine, device="cpu")
    assert want and set(got.records) == want


@pytest.fixture(scope="module")
def ecoli_digest(tmp_path_factory):
    """sha256 of the E.coli recipe's reads.fasta (tools/scale_test.py's
    defaults), made by the port's generator."""
    work = tmp_path_factory.mktemp("ecoli")
    fasta, _ = scale_test.make_dataset(scale_test.parse_args([]), work)
    return hashlib.sha256(fasta.read_bytes()).hexdigest()


@pytest.mark.parametrize("T", [1024, 2048])
def test_ecoli_oracle_digest_from_the_port_generator(ecoli_digest, T):
    """The T = 1024 and 2048 oracles were made on the E.coli recipe at
    seed 42: their digest is the port generator's, and
    tests/data/ecoli_shape's."""
    d = DATA / f"ecoli_shape_t{T}"
    assert (d / "dataset.sha256").read_text().split()[0] == ecoli_digest
    assert ((DATA / "ecoli_shape" / "dataset.sha256").read_text().split()[0]
            == ecoli_digest)
    assert f"tile_size = {T}" in (d / "README").read_text()
