"""End-to-end overlap pipeline: load -> index -> D-SOFT -> GACT -> records.

The port of darwin_tpu/pipeline.py, with its two engines.  On the
device engine both strands run as ONE merged engine batch
(run_device_merged): a multithreaded native D-SOFT pass over all
forward + reverse-complement read-strands, then one engine run with the
complement flag as per-call data.  The host-stepped engine (run_host)
mirrors the reference's per-direction flow: D-SOFT and run_gact_batch
per strand, the tiles aligned on the device each iteration.  The host
stages (FASTA, seed table, D-SOFT) run the port's own build of the
native library (darwin_tpu_torch.native) and fall back to NumPy without
it (io/fasta.py, index/seed_table.py, dsoft/filter.py: the port's copies
of darwin_tpu's host modules).  With dsoft="device" both engines seed on
the device instead (collect_calls_device: dsoft/device.py, one launch a
batch).  With mesh= (parallel/mesh.Mesh) the device engine is a
ShardedGactEngine and collect_calls_device seeds one block of reads a
mesh entry; collect_calls_table_sharded seeds with the seed table
sharded over the mesh (dsoft/sharded_table.py).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from darwin_tpu_torch import native
from darwin_tpu_torch.coding import seq_to_bytes
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.dsoft import dsoft
from darwin_tpu_torch.engine.aligner import TorchTileAligner
from darwin_tpu_torch.engine.batch import GactCalls, run_gact_batch
from darwin_tpu_torch.engine.device_batch import (DeviceGactEngine,
                                                  ShardedGactEngine)
from darwin_tpu_torch.engine.scoring import ScoreParams
from darwin_tpu_torch.engine.seqbank import SeqBank
from darwin_tpu_torch.golden.gact import format_record
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import FastaRecord, revcomp


@dataclasses.dataclass
class PipelineResult:
    records: list[str]
    num_candidates_for: int
    num_candidates_rev: int


def _no_calls() -> GactCalls:
    z = np.empty(0, dtype=np.int64)
    return GactCalls(z, z, z, z)


def collect_calls(table: SeedTable, genome: Genome, queries: SeqBank,
                  params: Params, read_ids=None,
                  num_threads: int | None = None) -> GactCalls:
    """Run D-SOFT for every query and decode hits to GACT anchors.

    Uses the port's multithreaded native D-SOFT when the library is
    built; falls back to the vectorized NumPy D-SOFT per read
    (dsoft/filter.py, as darwin_tpu.pipeline.collect_calls does).
    """
    ids = range(len(queries.lengths)) if read_ids is None else read_ids
    if native.available():
        ids_arr = np.asarray(list(ids), dtype=np.int64)
        counts, hits, offsets = native.dsoft_batch(
            table.hashes, table.pos, table.k, table.w, table.bin_size,
            table.ref_size, table.kmer_max_occurence, queries.flat,
            queries.starts, queries.lengths, ids_arr,
            params.num_seeds, params.threshold, params.max_candidates,
            num_threads)
        if len(hits) == 0:
            return _no_calls()
        chr_id, local = genome.decode_hits(hits)
        return GactCalls(chr_id, np.repeat(ids_arr, counts), local,
                         offsets)

    rid, qid, rpos, qpos = [], [], [], []
    for k in ids:
        seq = queries.slice(k, 0, int(queries.lengths[k]))
        hits, offsets = dsoft(table, seq, params.num_seeds,
                              params.threshold, params.max_candidates)
        if len(hits) == 0:
            continue
        chr_id, local = genome.decode_hits(hits)
        rid.append(chr_id)
        qid.append(np.full(len(hits), k, dtype=np.int64))
        rpos.append(local)
        qpos.append(offsets)
    if not rid:
        return _no_calls()
    return GactCalls(np.concatenate(rid), np.concatenate(qid),
                     np.concatenate(rpos), np.concatenate(qpos))


def _index_on(table: SeedTable, index: str, device: torch.device):
    """The seed table's index and positions on device for
    dsoft_device_batch, built once a (table, index, device): the
    two-level index's host arrays are cached on the table as
    darwin_tpu caches them (table._twolevel), the device copies beside
    them (table._device_index)."""
    from darwin_tpu_torch.dsoft.device import (device_index,
                                               make_twolevel_index)

    cache = table.__dict__.setdefault("_device_index", {})
    key = (index, str(device))
    if key not in cache:
        tl = None
        if index == "twolevel":
            tl = getattr(table, "_twolevel", None)
            if tl is None:
                tl = table._twolevel = make_twolevel_index(
                    np.asarray(table.hashes))
        cache[key] = device_index(table.hashes, table.pos, k=table.k,
                                  index=index, device=device, twolevel=tl)
    return cache[key]


def collect_calls_device(table: SeedTable, genome: Genome, queries: SeqBank,
                         params: Params, read_ids=None, *,
                         tup_max: int = 8192, cand_max: int = 512,
                         mesh=None, index: str = "auto",
                         device: torch.device | str = "cuda",
                         metrics: dict | None = None) -> GactCalls:
    """D-SOFT on the device for every query (or read_ids), decoded to
    GACT anchors: darwin_tpu.pipeline.collect_calls_device.

    The whole batch is one dsoft_device_batch call on device (no slicing,
    no shape buckets: those served XLA's compiles), or with mesh
    (parallel/mesh.Mesh) one a mesh entry (sharded_dsoft, the reads
    padded to a multiple of the mesh size, the index on every entry).
    Reads whose fixed tuple or candidate budget overflowed take the
    exact host D-SOFT, as in darwin_tpu, so the calls equal
    collect_calls'; with metrics, their number is added to
    dsoft_overflow_reads, and to dsoft_index_s the seconds spent
    building the index and placing it on the device (0 once it is
    cached on the table)."""
    from darwin_tpu_torch.dsoft.device import (default_index_mode,
                                               dsoft_device_batch, pad_reads,
                                               sharded_dsoft)

    ids = (np.arange(len(queries.lengths), dtype=np.int64)
           if read_ids is None else np.asarray(list(read_ids), np.int64))
    if metrics is not None:
        metrics.setdefault("dsoft_overflow_reads", 0)
    if len(ids) == 0:
        return _no_calls()
    if index == "auto":
        index = default_index_mode(table.k)
    kw = dict(k=table.k, w=table.w, bin_size=table.bin_size,
              kmer_max_occ=table.kmer_max_occurence,
              num_seeds_cap=params.num_seeds, threshold=params.threshold,
              max_candidates=params.max_candidates, tup_max=tup_max,
              cand_max=cand_max, index=index)
    Q, lens = pad_reads(queries, ids)
    t0 = time.perf_counter()
    if mesh is None:
        device = torch.device(device)
        th, tpos, tl_steps = _index_on(table, index, device)
    else:
        th, tpos, tl_steps = zip(*(_index_on(table, index, d)
                                   for d in mesh.devices))
    if metrics is not None:
        metrics["dsoft_index_s"] = (metrics.get("dsoft_index_s", 0.0)
                                    + time.perf_counter() - t0)
    if mesh is None:
        out = dsoft_device_batch(
            torch.from_numpy(Q).to(device), torch.from_numpy(lens).to(device),
            th, tpos, tl_steps=tl_steps, **kw)
    else:
        RM = -(-len(ids) // mesh.size) * mesh.size
        Q = np.pad(Q, ((0, RM - len(ids)), (0, 0)))
        lens = np.pad(lens, (0, RM - len(ids)))
        out = sharded_dsoft(mesh, torch.from_numpy(Q), torch.from_numpy(lens),
                            th, tpos, tl_steps=tl_steps[0], **kw)
    return _decode_calls(table, genome, queries, params, ids, out, metrics)


def _decode_calls(table, genome, queries, params, ids, out,
                  metrics) -> GactCalls:
    """GACT anchors from a device D-SOFT's (hits, offs, counts, overflow)
    over the reads ids (rows past len(ids) are padding); an overflowed
    read takes the exact host D-SOFT and is counted in
    metrics["dsoft_overflow_reads"]."""
    hits, offs, counts, over = (x[:len(ids)].cpu().numpy() for x in out)
    if metrics is not None:
        metrics["dsoft_overflow_reads"] = (
            metrics.get("dsoft_overflow_reads", 0) + int(over.sum()))
    h_all, o_all, q_all = [], [], []
    for r in np.flatnonzero(over | (counts > 0)):
        k = ids[r]
        if over[r]:  # exact host fallback, never truncate silently
            seq = queries.slice(k, 0, int(queries.lengths[k]))
            h, o = dsoft(table, seq, params.num_seeds, params.threshold,
                         params.max_candidates)
        else:
            h, o = hits[r, :counts[r]], offs[r, :counts[r]]
        h_all.append(np.asarray(h, np.int64))
        o_all.append(np.asarray(o, np.int64))
        q_all.append(np.full(len(h), k, dtype=np.int64))
    if not h_all or not sum(len(h) for h in h_all):
        return _no_calls()
    hits_m = np.concatenate(h_all)
    chr_id, local = genome.decode_hits(hits_m)
    return GactCalls(chr_id, np.concatenate(q_all), local,
                     np.concatenate(o_all))


def collect_calls_table_sharded(table: SeedTable, genome: Genome,
                                queries: SeqBank, params: Params, mesh,
                                read_ids=None, budgets=None,
                                exchange: str = "all_to_all",
                                metrics: dict | None = None) -> GactCalls:
    """Table-SHARDED D-SOFT over mesh (hash-range shards and the hit
    exchange; dsoft/sharded_table.py) decoded to GACT anchors:
    darwin_tpu.pipeline.collect_calls_table_sharded.

    Budgets default to workload-derived sizing (derive_budgets, 2x
    safety over the observed maxima), derived once a (table, mesh size)
    and cached on the table, as are the shards and their dense index
    (and their copies on the mesh's devices); the exchange is
    "all_to_all" (per-destination buckets of budgets.a2a_cap) or
    "all_gather".  Overflowing reads fall back to the exact host path,
    never silently truncate; with metrics, their number is added to
    dsoft_overflow_reads."""
    from darwin_tpu_torch.dsoft.device import pad_reads
    from darwin_tpu_torch.dsoft.sharded_table import (
        derive_budgets, dsoft_table_sharded, make_sharded_dense_index,
        make_sharded_table, place_shards)

    if exchange not in ("all_to_all", "all_gather"):
        raise ValueError(f"exchange {exchange!r}: all_to_all or all_gather")
    n_dev = mesh.size
    ids = (np.arange(len(queries.lengths), dtype=np.int64)
           if read_ids is None else np.asarray(list(read_ids), np.int64))
    if metrics is not None:
        metrics.setdefault("dsoft_overflow_reads", 0)
    if len(ids) == 0:
        return _no_calls()
    if budgets is None:
        # Deriving budgets replays the exact host D-SOFT over the batch:
        # once a (table, mesh size).  An under-sized later batch only
        # trips the overflow flag, which falls back to the exact host
        # path below.
        bcache = getattr(table, "_budget_cache", None)
        if bcache is not None and bcache[0] == n_dev:
            budgets = bcache[1]
        else:
            budgets = derive_budgets(
                table, [queries.slice(int(k), 0, int(queries.lengths[k]))
                        for k in ids],
                n_dev, num_seeds_cap=params.num_seeds,
                threshold=params.threshold,
                max_candidates=params.max_candidates)
            table._budget_cache = (n_dev, budgets)
    cached = getattr(table, "_shard_cache", None)
    if cached is None or cached[0] != n_dev:
        hs, ps = make_sharded_table(table.hashes, table.pos, n_dev)
        cached = table._shard_cache = (n_dev, hs, ps,
                                       make_sharded_dense_index(hs), {})
    _, hs, ps, di, placed = cached
    key = tuple(map(str, mesh.devices))
    if key not in placed:
        placed[key] = place_shards(mesh, hs, ps, di)
    Q, lens = pad_reads(queries, ids)
    RM = -(-len(ids) // n_dev) * n_dev
    Q = np.pad(Q, ((0, RM - len(ids)), (0, 0)))
    lens = np.pad(lens, (0, RM - len(ids)))
    out = dsoft_table_sharded(
        mesh, torch.from_numpy(Q), torch.from_numpy(lens), placed[key],
        k=table.k, w=table.w, bin_size=table.bin_size,
        kmer_max_occ=table.kmer_max_occurence,
        num_seeds_cap=params.num_seeds, threshold=params.threshold,
        max_candidates=params.max_candidates, tup_max=budgets.tup_max,
        cand_max=budgets.cand_max,
        a2a_cap=budgets.a2a_cap if exchange == "all_to_all" else None,
        index="dense", dense_steps=di.steps)
    return _decode_calls(table, genome, queries, params, ids, out, metrics)


def make_merged_engine(genome: Genome, fwd_bank: SeqBank,
                       rev_bank: SeqBank, params: Params, *,
                       same_file: bool, batch_size: int,
                       compute_score: bool = True,
                       device: torch.device | str = "cuda",
                       tb_format: str = "bytes", mesh=None):
    """Build the merged-bank engine once (bank upload included) so
    callers iterating over read ranges reuse it via run_device_merged's
    ``prebuilt`` argument: a DeviceGactEngine on device, or with mesh
    (parallel/mesh.Mesh) a ShardedGactEngine over it.  Returns (engine,
    merged bank, read count)."""
    num_reads = len(fwd_bank.lengths)
    merged = SeqBank.concat(fwd_bank, rev_bank)
    kw = dict(tile_size=params.tile_size,
              early_terminate=params.early_terminate,
              first_tile_score_threshold=params.first_tile_score_threshold,
              match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_extend=params.gap_extend,
              same_file=same_file, batch_size=batch_size,
              compute_score=compute_score, tb_format=tb_format)
    if mesh is not None:
        return ShardedGactEngine(genome, merged, mesh=mesh, **kw), merged, \
            num_reads
    return DeviceGactEngine(genome, merged, device=device, **kw), merged, \
        num_reads


def run_device_merged(genome: Genome, table: SeedTable,
                      fwd_bank: SeqBank, rev_bank: SeqBank,
                      params: Params, *, same_file: bool,
                      batch_size: int, compute_score: bool = True,
                      read_ids=None, num_threads: int | None = None,
                      dsoft: str = "host", prebuilt=None,
                      device: torch.device | str = "cuda", mesh=None,
                      metrics: dict | None = None):
    """Both strands as ONE merged engine batch, seeded by the native
    host D-SOFT (dsoft="host") or on the device (dsoft="device":
    collect_calls_device over the merged bank, on the engine's first
    device).  mesh (parallel/mesh.Mesh): a ShardedGactEngine over it,
    when prebuilt is None.

    Returns (records, [n_fwd_candidates, n_rev_candidates]).  With
    metrics, adds seed_s, align_s, engine_iters, engine_active_sum
    (slot-iterations with a call in flight) and drain_redispatches (the
    engine's second tiers) to it, and with the device D-SOFT
    dsoft_overflow_reads.
    """
    if prebuilt is not None:
        dev, merged, num_reads = prebuilt
    else:
        dev, merged, num_reads = make_merged_engine(
            genome, fwd_bank, rev_bank, params, same_file=same_file,
            batch_size=batch_size, compute_score=compute_score,
            device=device, mesh=mesh)
    if read_ids is None:
        merged_ids = None
    else:
        ids = np.asarray(list(read_ids), dtype=np.int64)
        merged_ids = np.concatenate([ids, ids + num_reads])
    t0 = time.perf_counter()
    calls_m = _seed(table, genome, merged, params, merged_ids, dsoft,
                    num_threads, dev.device, metrics)
    t1 = time.perf_counter()
    comp = (calls_m.query_id >= num_reads).astype(np.int32)
    counts = [int((comp == 0).sum()), int((comp == 1).sum())]
    calls = GactCalls(calls_m.ref_id, calls_m.query_id % num_reads,
                      calls_m.ref_pos, calls_m.query_pos)
    dev.last_iters = dev.last_active_sum = dev.last_drain_redispatches = 0
    recs = dev.finish(dev.run_async(calls, comp, calls_m.query_id))
    if metrics is not None:
        metrics["seed_s"] = metrics.get("seed_s", 0.0) + t1 - t0
        metrics["align_s"] = (metrics.get("align_s", 0.0)
                              + time.perf_counter() - t1)
        for key, n in (("engine_iters", dev.last_iters),
                       ("engine_active_sum", dev.last_active_sum),
                       ("drain_redispatches", dev.last_drain_redispatches)):
            metrics[key] = metrics.get(key, 0) + n
    return recs, counts


def _seed(table, genome, bank, params, read_ids, dsoft: str, num_threads,
          device, metrics) -> GactCalls:
    """The D-SOFT calls of read_ids in bank, on the host or the device."""
    if dsoft == "device":
        return collect_calls_device(table, genome, bank, params,
                                    read_ids=read_ids, device=device,
                                    metrics=metrics)
    if dsoft != "host":
        raise ValueError(f"dsoft {dsoft!r}: host or device")
    return collect_calls(table, genome, bank, params, read_ids=read_ids,
                         num_threads=num_threads)


def make_aligner(params: Params, device: torch.device | str
                 ) -> TorchTileAligner:
    """The host-stepped engine's tile aligner on device."""
    return TorchTileAligner(
        early_terminate=params.early_terminate,
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_extend=params.gap_extend,
        device=device, tile_size=params.tile_size)


def run_host(genome: Genome, table: SeedTable, fwd_bank: SeqBank,
             rev_bank: SeqBank, params: Params, *, same_file: bool,
             batch_size: int, aligner: TorchTileAligner,
             compute_score: bool = True, read_ids=None,
             num_threads: int | None = None, dsoft: str = "host",
             metrics: dict | None = None):
    """The host-stepped engine over both strands, one after the other
    (darwin_tpu.pipeline.run_pipeline's host branch): D-SOFT (on the
    host, or with dsoft="device" collect_calls_device on the aligner's
    device), then run_gact_batch, forward reads first.

    Returns (records, [n_fwd_candidates, n_rev_candidates]).  With
    metrics, adds seed_s, align_s and engine_iters (aligner calls), and
    with the device D-SOFT dsoft_overflow_reads."""
    sp = ScoreParams(params.match, params.mismatch, params.gap_open,
                     params.gap_extend)
    recs, counts = [], []
    for comp, bank in ((False, fwd_bank), (True, rev_bank)):
        t0 = time.perf_counter()
        calls = _seed(table, genome, bank, params, read_ids, dsoft,
                      num_threads, aligner.device, metrics)
        t1 = time.perf_counter()
        counts.append(len(calls))
        iters = aligner.calls
        recs.extend(run_gact_batch(
            genome, bank, calls, tile_size=params.tile_size,
            first_tile_score_threshold=params.first_tile_score_threshold,
            sp=sp, complement=comp, same_file=same_file, aligner=aligner,
            batch_size=batch_size, compute_score=compute_score))
        if metrics is not None:
            metrics["seed_s"] = metrics.get("seed_s", 0.0) + t1 - t0
            metrics["align_s"] = (metrics.get("align_s", 0.0)
                                  + time.perf_counter() - t1)
            metrics["engine_iters"] = (metrics.get("engine_iters", 0)
                                       + aligner.calls - iters)
    return recs, counts


def read_banks(read_records: list[FastaRecord]) -> tuple[SeqBank, SeqBank]:
    """Forward and reverse-complement read banks."""
    return (SeqBank([seq_to_bytes(r.seq) for r in read_records]),
            SeqBank([seq_to_bytes(revcomp(r.seq)) for r in read_records]))


def format_records(genome: Genome, read_records: list[FastaRecord],
                   recs) -> list[str]:
    """Overlap records as darwin.<i>.out lines."""
    return [format_record(genome.names[r.ref_id],
                          read_records[r.query_id].name, r.ab, r.ae, r.bb,
                          r.be, r.score, r.comp) for r in recs]


def run_pipeline(ref_records: list[FastaRecord],
                 read_records: list[FastaRecord], params: Params,
                 same_file: bool, *, batch_size: int = 512,
                 table: SeedTable | None = None,
                 compute_score: bool = True, engine: str = "device",
                 dsoft: str = "host", device: torch.device | str = "cuda",
                 metrics: dict | None = None) -> PipelineResult:
    """All reads against the reference on one device, by the device
    engine or the host-stepped one, seeded by the host D-SOFT or (dsoft=
    "device") on the device; record lines in the reference's
    darwin.<i>.out format.

    The engine (or the host engine's aligner) is built before the seed
    table, so that a tile size the device cannot take fails first.  With
    metrics, adds darwin_tpu.pipeline.run_pipeline's genome_banks_s,
    engine_build_s, table_s and format_s to what the engine adds."""
    if engine not in ("device", "host"):
        raise ValueError(f"engine {engine!r}: device or host")
    t0 = time.perf_counter()
    genome = Genome(ref_records, params.bin_size)
    fwd_bank, rev_bank = read_banks(read_records)
    t1 = time.perf_counter()
    kw = dict(same_file=same_file, batch_size=batch_size,
              compute_score=compute_score, dsoft=dsoft, metrics=metrics)
    if engine == "device":
        built = dict(prebuilt=make_merged_engine(
            genome, fwd_bank, rev_bank, params, same_file=same_file,
            batch_size=batch_size, compute_score=compute_score,
            device=device))
    else:
        built = dict(aligner=make_aligner(params, device))
    t2 = time.perf_counter()
    if table is None:
        table = SeedTable.build(genome.concat, params.seed_size,
                                params.seed_occurence_multiple,
                                params.bin_size, params.window_size)
    t3 = time.perf_counter()
    if metrics is not None:
        metrics.update(genome_banks_s=t1 - t0, engine_build_s=t2 - t1,
                       table_s=t3 - t2)
    run = run_device_merged if engine == "device" else run_host
    recs, counts = run(genome, table, fwd_bank, rev_bank, params, **built,
                       **kw)
    t4 = time.perf_counter()
    records = format_records(genome, read_records, recs)
    if metrics is not None:
        metrics["format_s"] = time.perf_counter() - t4
    return PipelineResult(records, counts[0], counts[1])
