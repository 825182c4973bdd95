"""Sensitivity / specificity evaluation against simulated ground truth.

The port's copy of darwin_tpu/eval/sensitivity.py.

Python-3 re-design of the reference's measure_sensitivity_PBSIM.py
(de-novo mode): ground-truth overlaps are recomputed from the genome
coordinates embedded in read names; reported overlaps are filtered by
score and aligned length and matched to the truth on (id1, id2) pairs.

Parity with the reference evaluator:
* read-name integers parsed with the same "all integer substrings" rule
  (measure_sensitivity_PBSIM.py:11-12) — a name R<id>_<pos>_<len> yields
  [id, pos, len];
* true overlap = genomic intervals intersecting >= 1000 bp (:103);
* reported overlap kept if score >= 600 and both aligned spans >= 990
  (:21-22, 171-172);
* optional AB->BA mirroring (extra=1, :146-148) and trivial self-overlap
  removal (:125-126, 167-169);
* a truth pair counts TP if ANY reported overlap matches the id pair
  (:194-212).
"""

from __future__ import annotations

import dataclasses
import re


def _ints(line: str) -> list[int]:
    return [int(x) for x in re.findall(r"\d+", line)]


@dataclasses.dataclass
class EvalResult:
    tp: int
    fn: int
    fp: int

    @property
    def sensitivity(self) -> float:
        return self.tp / max(1, self.tp + self.fn)

    @property
    def specificity(self) -> float:
        return self.tp / max(1, self.tp + self.fp)


def theoretical_overlaps(names: list[str], min_overlap: int = 1000,
                         remove_trivial: bool = True
                         ) -> list[tuple[int, int]]:
    """(idx1, idx2) pairs whose genomic intervals overlap enough."""
    info = [_ints(n) for n in names]
    out = []
    for i1, r1 in enumerate(info):
        a1, alen = r1[1], r1[2]
        a2 = a1 + alen
        for i2, r2 in enumerate(info):
            if remove_trivial and i1 == i2:
                continue
            b1 = r2[1]
            b2 = b1 + r2[2]
            if a2 < b1 or b2 < a1:
                continue
            if min(a2, b2) - max(a1, b1) >= min_overlap:
                out.append((i1, i2))
    return out


def measure_sensitivity_guided(records: list[str], num_reads: int,
                               score_thres: int = 600,
                               window: int = 50) -> EvalResult:
    """Reference-guided mode: reads mapped against a reference genome.

    Mirrors the reference evaluator's ref=1 branch
    (measure_sensitivity_PBSIM.py:152-162, 216-258): keep each read's
    highest-scoring record (ties: first in input order), count it TP
    when the read's true genome position lies strictly within +/-window
    of the reported reference start, else FP; unmapped reads are FN.

    Deviation from the reference (intended-semantics fix, documented):
    its best-per-read loop never flushes the final read group
    (measure_sensitivity_PBSIM.py:222-237), silently dropping the last
    read's record; we include it.
    """
    hovls = []
    for line in records:
        l = _ints(line)
        if len(l) < 10:
            continue
        # guided layout: [ref ints..., read_id, gen_pos, read_len,
        #                 ab, ae, bb, be, score, comp]
        l = l[-9:]  # read_id onward (ref name may carry any int count)
        if l[7] >= score_thres:
            hovls.append(l)

    best: dict[int, list[int]] = {}
    for h in hovls:
        read_id = h[0]
        if read_id not in best or h[7] > best[read_id][7]:
            best[read_id] = h

    tp = fp = 0
    for read_id, h in best.items():
        gen_pos, ref_start = h[1], h[3]
        if ref_start - window < gen_pos < ref_start + window:
            tp += 1
        else:
            fp += 1
    fn = num_reads - len(best)
    return EvalResult(tp=tp, fn=fn, fp=fp)


def measure_sensitivity(records: list[str], read_names: list[str],
                        score_thres: int = 600, min_length: int = 990,
                        min_overlap: int = 1000, extra: bool = True,
                        remove_trivial: bool = True) -> EvalResult:
    """Score overlap records (format_record lines) against ground truth.

    ``read_names`` is the FASTA name list; record names must appear in
    it (ids are recovered from the leading integer in each name, exactly
    like the reference's integer-parse of the record line).
    """
    hovls: list[list[int]] = []
    for line in records:
        l = _ints(line)
        # l = [ref_id, pos, len, read_id, pos, len, ab, ae, bb, be,
        #      score, comp]
        hovls.append(l + [0])
        if extra:
            hovls.append([l[3], l[4], l[5], l[0], l[1], l[2],
                          l[8], l[9], l[6], l[7], l[10], l[11], 0])

    if remove_trivial:
        hovls = [h for h in hovls if h[0] != h[3]]
    hovls = [h for h in hovls
             if h[7] - h[6] >= min_length and h[9] - h[8] >= min_length
             and h[10] >= score_thres]

    tovls = theoretical_overlaps(read_names, min_overlap, remove_trivial)

    by_pair: dict[tuple[int, int], list[list[int]]] = {}
    for h in hovls:
        by_pair.setdefault((h[0], h[3]), []).append(h)

    fn = 0
    for pair in tovls:
        matched = by_pair.get(pair)
        if matched:
            for h in matched:
                h[12] = 1
        else:
            fn += 1
    tp = sum(1 for h in hovls if h[12] == 1)
    fp = sum(1 for h in hovls if h[12] == 0)
    return EvalResult(tp=tp, fn=fn, fp=fp)


def _main(argv=None) -> int:
    """Script-level usage mirroring measure_sensitivity_PBSIM.py:

        python -m darwin_tpu_torch.eval.sensitivity OUT.darwin READS.fasta \\
            [--score-thres 600] [--min-length 990] [--min-overlap 1000]
            [--guided] [--window 50]
    """
    import argparse

    from darwin_tpu_torch.io.fasta import parse_fasta

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("overlaps", help="merged overlap records (out.darwin)")
    p.add_argument("reads", help="reads FASTA with PBSIM-style names")
    p.add_argument("--score-thres", type=int, default=600)
    p.add_argument("--min-length", type=int, default=990)
    p.add_argument("--min-overlap", type=int, default=1000)
    p.add_argument("--guided", action="store_true",
                   help="reference-guided mode (+/-window bp position)")
    p.add_argument("--window", type=int, default=50)
    args = p.parse_args(argv)

    records = [l for l in open(args.overlaps).read().splitlines() if l]
    names = [r.name for r in parse_fasta(args.reads)]
    if args.guided:
        res = measure_sensitivity_guided(records, len(names),
                                         score_thres=args.score_thres,
                                         window=args.window)
    else:
        res = measure_sensitivity(records, names,
                                  score_thres=args.score_thres,
                                  min_length=args.min_length,
                                  min_overlap=args.min_overlap)
    print(f"TP: {res.tp}")
    print(f"FN: {res.fn}")
    print(f"FP: {res.fp}")
    print(f"sensitivity: {res.sensitivity:.6f}")
    print(f"specificity: {res.specificity:.6f}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
