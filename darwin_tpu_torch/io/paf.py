"""PAF (Pairwise mApping Format) output for overlap records.

A copy of darwin_tpu/io/paf.py over the port's OverlapRecord (that
module imports jax through darwin_tpu.engine).

Out of reference scope (the reference emits only its own `ref_id: ...`
record lines) but expected by the long-read ecosystem (minimap2/miniasm
tooling).  Coordinate conversion from the reference record convention
(gact.cpp:213-225): ab/ae and bb/be are 0-based half-open spans on the
reference piece and on the ALIGNED query strand; for comp=1 records the
query span is mapped back to the original read strand, as PAF requires.

Column 10 (matching bases) uses the engine's exact per-record match
count (OverlapRecord.nmatch; 0 under --noscore).  Column 11 is the
exact alignment block length (matches + mismatches + gap columns =
OverlapRecord.ncols, the engine's op-stream length); for records that
carry no op-stream tally (ncols == 0, e.g. re-parsed from .out text)
it falls back to max(span_r, span_q), which is a LOWER bound on the
block length.  mapq is 255 (unavailable).  The score is carried as an
AS:i tag.
"""

from __future__ import annotations

from darwin_tpu_torch.engine.batch import OverlapRecord


def paf_line(rec: OverlapRecord, ref_name: str, ref_len: int,
             query_name: str, query_len: int) -> str:
    if rec.comp:
        qs, qe = query_len - rec.be, query_len - rec.bb
    else:
        qs, qe = rec.bb, rec.be
    blk = rec.ncols if rec.ncols > 0 else max(rec.ae - rec.ab,
                                              rec.be - rec.bb)
    cols = [query_name, query_len, qs, qe,
            "-" if rec.comp else "+",
            ref_name, ref_len, rec.ab, rec.ae,
            rec.nmatch, blk, 255, f"AS:i:{rec.score}"]
    return "\t".join(str(c) for c in cols)


def paf_lines(records, genome, read_names, read_lengths) -> list[str]:
    """PAF lines for OverlapRecords against a Genome + read metadata."""
    out = []
    for r in records:
        out.append(paf_line(
            r, genome.names[r.ref_id],
            int(genome.piece_lengths[r.ref_id]),
            read_names[r.query_id], int(read_lengths[r.query_id])))
    return out
