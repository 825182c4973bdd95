"""darwin_tpu_torch's mesh layer against darwin_tpu's, on meshes of the
same size (JAX's 8 virtual CPU devices, tests/conftest.py; the port's
["cpu"] * n):

* ShardedTileAligner against darwin_tpu's (backend "lax") on
  __graft_entry__'s example batch: every TileResult field equal, and
  against the one-device TorchTileAligner;
* merge_overlap_records against darwin_tpu's;
* balance_calls against darwin_tpu's on skewed loads;
* ShardedGactEngine against darwin_tpu's ShardedGactEngine and the
  port's DeviceGactEngine on the tiny fixture's merged-strand calls, and
  on skewed read lengths: the same record set (the slot pools differ, so
  the order does);
* make_mesh raises when fewer CUDA devices are visible than asked for;
* collectives.on_each runs the entries in turn, in the calling thread.
"""

import dataclasses
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from darwin_tpu.engine import device_batch as jdb
from darwin_tpu.engine.seqbank import SeqBank as JaxSeqBank
from darwin_tpu.parallel import mesh as jax_mesh
from darwin_tpu_torch.coding import seq_to_bytes
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.engine.aligner import TorchTileAligner
from darwin_tpu_torch.engine.batch import GactCalls
from darwin_tpu_torch.engine.device_batch import (DeviceGactEngine,
                                                  ShardedGactEngine,
                                                  balance_calls)
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.eval.datagen import sample_reads, synth_genome
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import FastaRecord, parse_fasta, revcomp
from darwin_tpu_torch.parallel.collectives import on_each
from darwin_tpu_torch.parallel.mesh import (ShardedTileAligner, make_mesh,
                                            merge_overlap_records)
from darwin_tpu_torch.pipeline import collect_calls
from tests._torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import __graft_entry__  # noqa: E402

P = 8


def test_sharded_tile_aligner_equals_jax():
    T, ET = 32, 12
    batch = __graft_entry__._example_batch(45, T, seed=5)  # pads to 48
    kw = dict(tile_size=T, early_terminate=ET, match=1, mismatch=-1,
              gap_open=-1, gap_extend=-1)
    want = jax_mesh.ShardedTileAligner(jax_mesh.make_mesh(P), backend="lax",
                                       **kw)(*batch)
    got = ShardedTileAligner(make_mesh(devices=["cpu"] * P), **kw)(*batch)
    kw.pop("tile_size")
    one = TorchTileAligner(device="cpu", **kw)(*batch)
    for name in ("ops", "ref_steps", "query_steps", "score", "max_i",
                 "max_j"):
        g = getattr(got, name)
        np.testing.assert_array_equal(g, getattr(want, name), err_msg=name)
        np.testing.assert_array_equal(g, getattr(one, name), err_msg=name)
        assert g.dtype == getattr(want, name).dtype, name


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_overlap_records_equals_jax(seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 5, size=(16, 8)).astype(np.int32)
    rows[rng.integers(0, 16, size=3), 0] = -1  # padding rows
    want = jax_mesh.merge_overlap_records(jax_mesh.make_mesh(P), rows)
    got = merge_overlap_records(make_mesh(devices=["cpu"] * P), rows)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("n,nd", [(64, 8), (37, 8), (5, 8), (0, 4),
                                  (100, 3)])
def test_balance_calls_equals_jax(n, nd):
    rng = np.random.default_rng(n)
    costs = np.where(rng.random(n) < 0.25, 8000, 400) + rng.integers(
        0, 50, size=n)
    got = balance_calls(costs, nd)
    want = jdb.balance_calls(costs, nd)
    assert len(got) == len(want) == nd
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _engine_kw(params, batch):
    return dict(tile_size=params.tile_size,
                early_terminate=params.early_terminate,
                first_tile_score_threshold=params.first_tile_score_threshold,
                match=params.match, mismatch=params.mismatch,
                gap_open=params.gap_open, gap_extend=params.gap_extend,
                batch_size=batch)


def _merged_calls(reads, params):
    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size)
    fwd = [seq_to_bytes(r.seq) for r in reads]
    rev = [seq_to_bytes(revcomp(r.seq)) for r in reads]
    merged = SeqBank(fwd + rev)
    calls_m = collect_calls(table, genome, merged, params)
    R = len(reads)
    calls = GactCalls(calls_m.ref_id, calls_m.query_id % R,
                      calls_m.ref_pos, calls_m.query_pos)
    comp = (calls_m.query_id >= R).astype(np.int32)
    return genome, fwd + rev, calls, comp, calls_m.query_id


def _records(recs):
    return sorted(dataclasses.astuple(r) for r in recs)


def test_sharded_engine_equals_jax_and_one_device(data_dir):
    d = data_dir / "tiny"
    params = Params.from_cfg(d / "params.cfg")
    genome, strands, calls, comp, bank_ids = _merged_calls(
        parse_fasta(d / "reads.fasta"), params)
    kw = _engine_kw(params, 32)
    eng = ShardedGactEngine(genome, SeqBank(strands),
                            mesh=make_mesh(devices=["cpu"] * P),
                            same_file=True, **kw)
    got = eng.finish(eng.run_async(calls, comp, bank_ids))
    one = DeviceGactEngine(genome, SeqBank(strands), device="cpu",
                           same_file=True, **kw)
    want_one = one.finish(one.run_async(calls, comp, bank_ids))
    jeng = jdb.ShardedGactEngine(genome, JaxSeqBank(strands),
                                 mesh=jax_mesh.make_mesh(P), same_file=True,
                                 backend="lax", **kw)
    want = jeng.finish(jeng.run_async(calls, comp, bank_ids))
    assert len(got) > 0
    assert _records(got) == _records(want) == _records(want_one)
    assert eng.last_iters == sum(e.last_iters for e in eng.engines) > 0


def test_sharded_engine_skewed_read_lengths():
    """Long reads first, so a contiguous split would put every long call
    on one entry; the cost-aware split's entries run different numbers
    of iterations, and the records equal the one-device engine's."""
    rng = np.random.default_rng(123)
    g = synth_genome(30_000, rng)
    reads = [FastaRecord([n], s) for n, s in
             sample_reads(g, 3, 3_000, rng, error_rate=0.05,
                          rc_fraction=0.3)
             + sample_reads(g, 12, 500, rng, error_rate=0.05,
                            rc_fraction=0.3)]
    params = Params(seed_size=12, tile_size=64, tile_overlap=24,
                    threshold=12, bin_size=32)
    genome, strands, calls, comp, bank_ids = _merged_calls(reads, params)
    assert len(calls) >= 16
    kw = _engine_kw(params, 64)
    eng = ShardedGactEngine(genome, SeqBank(strands),
                            mesh=make_mesh(devices=["cpu"] * 4),
                            same_file=True, **kw)
    got = eng.finish(eng.run_async(calls, comp, bank_ids))
    one = DeviceGactEngine(genome, SeqBank(strands), device="cpu",
                           same_file=True, **kw)
    want = one.finish(one.run_async(calls, comp, bank_ids))
    assert len(got) > 0 and _records(got) == _records(want)
    loads = [int(SeqBank(strands).lengths[bank_ids][p].sum())
             for p in balance_calls(SeqBank(strands).lengths[bank_ids], 4)]
    assert max(loads) <= 1.2 * np.mean(loads)


def test_make_mesh_raises_on_too_few_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(RuntimeError, match="2 CUDA devices asked for, 1 "
                                           "visible"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="0 visible"):
        make_mesh()
    mesh = make_mesh(devices=["cuda:0"] * 4)
    assert mesh.size == 4 and mesh.axis_names == ("data",)
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 2)
    assert len(jax.devices()) >= P


def test_on_each_runs_entries_in_turn_in_the_calling_thread():
    """One path on every device type: entry i's call runs i-th, in the
    caller's thread, and its result is the i-th."""
    seen = []

    def fn(i):
        seen.append((i, threading.get_ident()))
        return 10 * i

    assert on_each(["cpu"] * 5, fn) == [0, 10, 20, 30, 40]
    assert seen == [(i, threading.get_ident()) for i in range(5)]
