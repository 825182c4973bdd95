"""Entry points: the one-device step and the multi-device dryrun.

The port of __graft_entry__.py.  entry() returns the flagship step (the
batched GACT tile aligner: the tile DP and the byte walker) and its
example batch as tensors on a device; dryrun_multichip(n) runs the
multi-device layer over a mesh of n devices at a full-size shape (a 256
kb reference, 2 kb reads, the default T = 320 tile geometry) and holds
each sharded function to its one-device counterpart:

* the sharded tile aligner's scores are non-negative over the batch;
* the record merge drops padding rows and sorts;
* the table-sharded D-SOFT with workload-derived budgets equals the host
  D-SOFT (dsoft/filter.py) read for read, with no overflow;
* ShardedGactEngine's records equal the one-device DeviceGactEngine's on
  those D-SOFT anchors.

    python -m darwin_tpu_torch.entry

runs entry()'s step on the card and the dryrun over every visible CUDA
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _example_batch(B: int, T: int, seed: int = 0):
    """B related ref/query tiles of size T (lengths T/2..T, the query a
    prefix of the ref, padded), the first half first tiles (numpy)."""
    from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = np.full((B, T), PAD_REF, dtype=np.uint8)
    query = np.full((B, T), PAD_QUERY, dtype=np.uint8)
    rlen = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    qlen = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    for b in range(B):
        r = alpha[rng.integers(0, 4, size=rlen[b])]
        q = r[: qlen[b]].copy()
        if len(q) < qlen[b]:
            q = np.concatenate(
                [q, alpha[rng.integers(0, 4, size=qlen[b] - len(q))]])
        ref[b, : rlen[b]] = r
        query[b, : qlen[b]] = q
    firsts = np.zeros(B, dtype=bool)
    firsts[: B // 2] = True
    return ref, query, rlen, qlen, firsts


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): the forward step of the flagship model, the
    batched GACT tile aligner (the tile DP in dir bytes and the byte
    walker), and a B = 64, T = 64 batch as tensors on device."""
    from darwin_tpu_torch.ops.dp import align_tiles
    from darwin_tpu_torch.ops.traceback import traceback

    B, T, ET = 64, 64, 24

    def fn(ref, query, rlen, qlen, first):
        out = align_tiles(ref, query, rlen, qlen, match=1, mismatch=-1,
                          gap_open=-1, gap_extend=-1)
        ops, i_steps, j_steps = traceback(
            out["dir"], rlen, qlen, first, out["max_i"], out["max_j"],
            early_terminate=ET)
        score = torch.where(first, out["max_score"], out["pos_score"])
        return ops, i_steps, j_steps, score

    return fn, tuple(torch.from_numpy(x).to(device)
                     for x in _example_batch(B, T))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the multi-device layer over a mesh of n_devices (the first
    n CUDA devices, or devices= such as ["cuda:0"] * 4 or ["cpu"] * 2)
    at a full-size shape and assert parity against the one-device paths
    (see the module's docstring); prints one line of what it held."""
    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.dsoft.device import pad_reads
    from darwin_tpu_torch.dsoft.filter import dsoft as host_dsoft
    from darwin_tpu_torch.dsoft.sharded_table import (
        derive_budgets, dsoft_table_sharded, make_sharded_dense_index,
        make_sharded_table, place_shards)
    from darwin_tpu_torch.engine.batch import GactCalls
    from darwin_tpu_torch.engine.device_batch import (DeviceGactEngine,
                                                      ShardedGactEngine)
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.index.genome import Genome
    from darwin_tpu_torch.index.seed_table import SeedTable
    from darwin_tpu_torch.io.fasta import FastaRecord
    from darwin_tpu_torch.parallel.mesh import (ShardedTileAligner, make_mesh,
                                                merge_overlap_records)

    mesh = make_mesh(n_devices, devices=devices)

    B, T = 8 * n_devices, 16
    aligner = ShardedTileAligner(
        mesh, tile_size=T, early_terminate=8, match=1, mismatch=-1,
        gap_open=-1, gap_extend=-1)
    res = aligner(*_example_batch(B, T, seed=1))
    if res.ops.shape[0] != B or not (res.score >= 0).all():
        raise AssertionError("sharded tile aligner: wrong batch or scores")

    # Cross-device deterministic overlap merge (sort | uniq analogue).
    rows = np.zeros((2 * n_devices, 8), dtype=np.int32)
    rows[:, 0] = np.arange(2 * n_devices)[::-1] % 3
    rows[:, 6] = 100
    rows[1::2, 0] = -1  # padding rows dropped by the merge
    merged = merge_overlap_records(mesh, rows)
    if not (np.diff(merged[:, 0]) >= 0).all() or (merged[:, 0] < 0).any():
        raise AssertionError("merge_overlap_records: not sorted")

    # Table-sharded D-SOFT with the hit exchange, budgets derived from the
    # workload, every read's candidates equal to the host filtration's.
    params = Params()  # production defaults: k=14, T=320, ET=200
    rng = np.random.default_rng(2)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    G, L = 262_144, 2_000
    ref_seq = alpha[rng.integers(0, 4, size=G)]
    table = SeedTable.build(ref_seq, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    n_reads = 2 * n_devices
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, G - L))
        r = ref_seq[s:s + L].copy()
        mut = rng.random(L) < 0.1
        r[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
        reads.append(r)
    bank = SeqBank(reads)
    Q, lens = pad_reads(bank, range(len(reads)))
    bud = derive_budgets(table, reads, n_devices,
                         num_seeds_cap=params.num_seeds,
                         threshold=params.threshold,
                         max_candidates=params.max_candidates)
    hs, ps = make_sharded_table(table.hashes, table.pos, n_devices)
    di = make_sharded_dense_index(hs)
    out = dsoft_table_sharded(
        mesh, torch.from_numpy(Q), torch.from_numpy(lens),
        place_shards(mesh, hs, ps, di), k=table.k, w=table.w,
        bin_size=table.bin_size, kmer_max_occ=table.kmer_max_occurence,
        num_seeds_cap=params.num_seeds, threshold=params.threshold,
        max_candidates=params.max_candidates, tup_max=bud.tup_max,
        cand_max=bud.cand_max, a2a_cap=bud.a2a_cap, index="dense",
        dense_steps=di.steps)
    hits, offs, counts, over = (x.cpu().numpy() for x in out)
    if over.any():
        raise AssertionError("derived budgets overflowed")
    for i, r in enumerate(reads):
        oh, oo = host_dsoft(table, r, params.num_seeds, params.threshold,
                            params.max_candidates)
        got = list(zip(hits[i, :counts[i]].tolist(),
                       offs[i, :counts[i]].tolist()))
        if got != list(zip(oh.tolist(), oo.tolist())):
            raise AssertionError(f"sharded D-SOFT differs on read {i}")
    if counts.sum() <= 0:
        raise AssertionError("sharded D-SOFT found no candidate")

    # The sharded engine at the production tile geometry on those
    # anchors: its records equal the one-device engine's.
    genome = Genome([FastaRecord(["g"], ref_seq.tobytes().decode())], 64)
    anchors = GactCalls(
        np.zeros(int(counts.sum()), np.int64),
        np.repeat(np.arange(len(reads), dtype=np.int64), counts),
        np.concatenate([hits[i, :c] for i, c in enumerate(counts)]),
        np.concatenate([offs[i, :c] for i, c in enumerate(counts)]
                       ).astype(np.int64))
    kw = dict(tile_size=params.tile_size,
              early_terminate=params.early_terminate,
              first_tile_score_threshold=params.first_tile_score_threshold,
              match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_extend=params.gap_extend,
              same_file=False, batch_size=8 * n_devices)
    eng = ShardedGactEngine(genome, bank, mesh=mesh, **kw)
    recs = eng.run(anchors, False)
    one = DeviceGactEngine(genome, bank, device=mesh.devices[0], **kw)
    want = one.run(anchors, False)
    key = dataclasses.astuple
    if sorted(map(key, recs)) != sorted(map(key, want)) or not recs:
        raise AssertionError(f"sharded engine records diverge: {len(recs)} "
                             f"vs {len(want)}")

    print(f"dryrun_multichip OK: {n_devices} devices "
          f"({', '.join(map(str, mesh.devices))}), batch {B}, "
          f"{len(merged)} merged records; sharded D-SOFT parity EXACT "
          f"({int(counts.sum())} candidates, {G} b table, {L} b reads, "
          f"derived budgets tup={bud.tup_max}/cand={bud.cand_max}/"
          f"a2a={bud.a2a_cap}); sharded engine parity EXACT "
          f"({len(recs)} records, T={params.tile_size})")


if __name__ == "__main__":
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    print("entry() runs")
    dryrun_multichip(torch.cuda.device_count())
