"""Golden end-to-end pipeline: the CPU reference path in miniature.

The port's copy of darwin_tpu/golden/pipeline.py, on the port's host
modules.

Mirrors the reference driver's per-read flow (darwin.cpp:166-288, CPU
build): D-SOFT on the forward read then on its reverse complement, each
candidate decoded through the bin maps and extended with scalar GACT.
Used only in tests on tiny fixtures.
"""

from __future__ import annotations

from darwin_tpu_torch.coding import seq_to_bytes
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.golden.dsoft import GoldenSeedTable, dsoft_scalar
from darwin_tpu_torch.golden.gact import (SCORE_THRESHOLD, format_record,
                                          gact_scalar)
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.io.fasta import FastaRecord, revcomp


def golden_pipeline(ref_records: list[FastaRecord],
                    read_records: list[FastaRecord],
                    params: Params, same_file: bool) -> list[str]:
    genome = Genome(ref_records, params.bin_size)
    table = GoldenSeedTable(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)

    records: list[str] = []

    def run_candidates(read_id: int, query_bytes, comp: bool) -> None:
        candidates = dsoft_scalar(table, query_bytes, params.num_seeds,
                                  params.threshold, params.max_candidates)
        for hit, offset in candidates:
            chr_id, local = genome.decode_hits([hit])
            chr_id, ref_pos = int(chr_id[0]), int(local[0])
            ab, ae, bb, be, score = gact_scalar(
                genome.piece_bytes[chr_id], query_bytes,
                params.tile_size, params.tile_overlap,
                ref_pos, offset, params.first_tile_score_threshold,
                params.match, params.mismatch,
                params.gap_open, params.gap_extend)
            if not (same_file and chr_id == read_id) \
                    and score > SCORE_THRESHOLD:
                records.append(format_record(
                    genome.names[chr_id], read_records[read_id].name,
                    ab, ae, bb, be, score, comp))

    for k, rec in enumerate(read_records):
        fwd = seq_to_bytes(rec.seq)
        rev = seq_to_bytes(revcomp(rec.seq))
        run_candidates(k, fwd, False)
        run_candidates(k, rev, True)
    return records
