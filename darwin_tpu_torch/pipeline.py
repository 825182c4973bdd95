"""End-to-end overlap pipeline: load -> index -> D-SOFT -> GACT -> records.

The port of darwin_tpu/pipeline.py's device path.  Both strands run as
ONE merged engine batch (run_device_merged): a multithreaded native
D-SOFT pass over all forward + reverse-complement read-strands, then
one engine run with the complement flag as per-call data.  D-SOFT, the
seed table, the genome layout and record formatting are darwin_tpu's
jax-free host modules, shared as they are.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from darwin_tpu import native
from darwin_tpu.coding import seq_to_bytes
from darwin_tpu.config import Params
from darwin_tpu.dsoft import dsoft
from darwin_tpu.golden.gact import format_record
from darwin_tpu.index.genome import Genome
from darwin_tpu.index.seed_table import SeedTable
from darwin_tpu.io.fasta import FastaRecord, revcomp
from darwin_tpu_torch.engine.batch import GactCalls
from darwin_tpu_torch.engine.device_batch import DeviceGactEngine
from darwin_tpu_torch.engine.seqbank import SeqBank


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

    Uses the multithreaded native host engine when available; falls
    back to the vectorized NumPy D-SOFT per read (as
    darwin_tpu.pipeline.collect_calls does).
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


def make_merged_engine(genome: Genome, fwd_bank: SeqBank,
                       rev_bank: SeqBank, params: Params, *,
                       same_file: bool, batch_size: int,
                       compute_score: bool = True,
                       device: torch.device | str):
    """Build the merged-bank engine once (bank upload included) so
    callers iterating over read ranges reuse it via run_device_merged's
    ``prebuilt`` argument.  Returns (engine, merged bank, read count)."""
    num_reads = len(fwd_bank.lengths)
    merged = SeqBank.concat(fwd_bank, rev_bank)
    dev = DeviceGactEngine(
        genome, merged, tile_size=params.tile_size,
        early_terminate=params.early_terminate,
        first_tile_score_threshold=params.first_tile_score_threshold,
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_extend=params.gap_extend,
        same_file=same_file, batch_size=batch_size,
        compute_score=compute_score, device=device)
    return dev, merged, num_reads


def run_device_merged(genome: Genome, table: SeedTable,
                      fwd_bank: SeqBank, rev_bank: SeqBank,
                      params: Params, *, same_file: bool,
                      batch_size: int, compute_score: bool = True,
                      read_ids=None, num_threads: int | None = None,
                      prebuilt=None, device: torch.device | str = "cuda",
                      metrics: dict | None = None):
    """Both strands as ONE merged engine batch.

    Returns (records, [n_fwd_candidates, n_rev_candidates]).  With
    metrics, adds seed_s, align_s, engine_iters and engine_active_sum
    (slot-iterations with a call in flight) to it.
    """
    if prebuilt is not None:
        dev, merged, num_reads = prebuilt
    else:
        dev, merged, num_reads = make_merged_engine(
            genome, fwd_bank, rev_bank, params, same_file=same_file,
            batch_size=batch_size, compute_score=compute_score,
            device=device)
    if read_ids is None:
        merged_ids = None
    else:
        ids = np.asarray(list(read_ids), dtype=np.int64)
        merged_ids = np.concatenate([ids, ids + num_reads])
    t0 = time.perf_counter()
    calls_m = collect_calls(table, genome, merged, params,
                            read_ids=merged_ids, num_threads=num_threads)
    t1 = time.perf_counter()
    comp = (calls_m.query_id >= num_reads).astype(np.int32)
    counts = [int((comp == 0).sum()), int((comp == 1).sum())]
    calls = GactCalls(calls_m.ref_id, calls_m.query_id % num_reads,
                      calls_m.ref_pos, calls_m.query_pos)
    dev.last_iters = dev.last_active_sum = 0
    recs = dev.finish(dev.run_async(calls, comp, calls_m.query_id))
    if metrics is not None:
        metrics["seed_s"] = metrics.get("seed_s", 0.0) + t1 - t0
        metrics["align_s"] = (metrics.get("align_s", 0.0)
                              + time.perf_counter() - t1)
        metrics["engine_iters"] = (metrics.get("engine_iters", 0)
                                   + dev.last_iters)
        metrics["engine_active_sum"] = (metrics.get("engine_active_sum", 0)
                                        + dev.last_active_sum)
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
                 compute_score: bool = True,
                 device: torch.device | str = "cuda",
                 metrics: dict | None = None) -> PipelineResult:
    """All reads against the reference on one device; record lines in
    the reference's darwin.<i>.out format."""
    genome = Genome(ref_records, params.bin_size)
    if table is None:
        table = SeedTable.build(genome.concat, params.seed_size,
                                params.seed_occurence_multiple,
                                params.bin_size, params.window_size)
    fwd_bank, rev_bank = read_banks(read_records)
    recs, counts = run_device_merged(
        genome, table, fwd_bank, rev_bank, params, same_file=same_file,
        batch_size=batch_size, compute_score=compute_score,
        device=device, metrics=metrics)
    return PipelineResult(format_records(genome, read_records, recs),
                          counts[0], counts[1])
