"""Score-accuracy evaluation: reported scores vs exact SW scores.

The port of darwin_tpu/eval/score_eval.py (the NPBSS score evaluator,
reference .measure_sensitivity_NPBSS.py): theoretical overlaps from the
origin coordinates in the read names, the exact local affine score of
every theoretically-overlapping pair, and darwin's reported overlaps
matched to them by (ref read, query read) id pair.  The exact scores
come from the port's score-only SW (ops/swscore.py: the CUDA kernel on
a card, its plain version on the CPU).  theoretical_pairs, _ints and
ScoreEvalResult are copies of darwin_tpu's.

    python -m darwin_tpu_torch.eval.score_eval OUT.darwin REF.fasta \\
        READS.fasta [--min-overlap 1000] [--params params.cfg]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys

import numpy as np
import torch

from darwin_tpu_torch.config import Params
from darwin_tpu_torch.io.fasta import parse_fasta, revcomp
from darwin_tpu_torch.ops.swscore import local_score_batch


def _ints(line: str) -> list[int]:
    return [int(x) for x in re.findall(r"\d+", line)]


@dataclasses.dataclass
class ScoreEvalResult:
    n_theoretical: int
    n_matched: int
    same_score: int
    higher_score: int     # reported > exact (shouldn't happen for
    lower_score: int      # exact SW; reference tracked it anyway)
    c1: int               # higher, diff < 50   (reference counters)
    c2: int               # higher, diff < 200
    c3: int               # lower, diff < 20
    fn: int
    fp: int


def theoretical_pairs(names1: list[str], names2: list[str],
                      min_overlap: int = 1000
                      ) -> list[tuple[int, int]]:
    """(idx1, idx2) of reads whose genomic intervals overlap enough
    (.measure_sensitivity_NPBSS.py:57-88: a2<b1 / b2<a1 exclusion,
    ovl_length > min_overlap)."""
    info1 = [_ints(n) for n in names1]
    info2 = [_ints(n) for n in names2]
    out = []
    for i1, r1 in enumerate(info1):
        a1, a2 = r1[1], r1[1] + r1[2]
        for i2, r2 in enumerate(info2):
            b1, b2 = r2[1], r2[1] + r2[2]
            if a2 < b1 or b2 < a1:
                continue
            if min(a2, b2) - max(a1, b1) > min_overlap:
                out.append((i1, i2))
    return out


def pair_arrays(seq_pairs: list[tuple[str, str]]):
    """One batch of (seq1, seq2) pairs as the SW op's inputs: zero-padded
    [B, L1] and [B, L2] uint8 arrays and their [B] int32 lengths."""
    l1 = max(len(s1) for s1, _ in seq_pairs)
    l2 = max(len(s2) for _, s2 in seq_pairs)
    a = np.zeros((len(seq_pairs), l1), np.uint8)
    b = np.zeros((len(seq_pairs), l2), np.uint8)
    al = np.zeros(len(seq_pairs), np.int32)
    bl = np.zeros(len(seq_pairs), np.int32)
    for r, (s1, s2) in enumerate(seq_pairs):
        e1, e2 = s1.encode(), s2.encode()
        a[r, : len(e1)] = np.frombuffer(e1, np.uint8)
        b[r, : len(e2)] = np.frombuffer(e2, np.uint8)
        al[r], bl[r] = len(e1), len(e2)
    return a, b, al, bl


def exact_pair_scores(seq_pairs: list[tuple[str, str]], *, match: int,
                      mismatch: int, gap_open: int, gap_extend: int,
                      batch: int = 64,
                      device: torch.device | str = "cuda") -> list[int]:
    """Exact local SW score for each (seq1, seq2) pair, `batch` pairs a
    call on device; full read lengths, no tiling approximation."""
    dev = torch.device(device)
    scores: list[int] = []
    for lo in range(0, len(seq_pairs), batch):
        got = local_score_batch(
            *(torch.from_numpy(x).to(dev)
              for x in pair_arrays(seq_pairs[lo: lo + batch])),
            match=match, mismatch=mismatch, gap_open=gap_open,
            gap_extend=gap_extend)
        scores.extend(int(x) for x in got.cpu().numpy())
    return scores


def evaluate_scores(records: list[str], names1: list[str],
                    names2: list[str], seqs1: list[str],
                    seqs2: list[str], *, match: int = 1,
                    mismatch: int = -1, gap_open: int = -1,
                    gap_extend: int = -1, min_overlap: int = 1000,
                    device: torch.device | str = "cuda"
                    ) -> ScoreEvalResult:
    """Compare darwin record scores to exact pair scores (contract of
    darwin_tpu.eval.score_eval.evaluate_scores).

    ``records`` are format_record lines from a ref=file1, reads=file2
    run; ids are recovered by integer-parsing like the reference.  A
    comp=1 record aligned the read's reverse complement, so it is
    compared against the exact score of that strand.
    """
    hovls = [_ints(line) + [0] for line in records]
    pairs = theoretical_pairs(names1, names2, min_overlap)
    pair_set = set(pairs)
    keys = sorted(
        {(h[0], h[3], h[11]) for h in hovls
         if (h[0], h[3]) in pair_set} |
        {(i1, i2, 0) for (i1, i2) in pairs})
    seqs2_rc = {j: revcomp(seqs2[j]) for (_, j, c) in keys if c}
    exact = dict(zip(keys, exact_pair_scores(
        [(seqs1[i], seqs2_rc[j] if c else seqs2[j]) for (i, j, c) in keys],
        match=match, mismatch=mismatch, gap_open=gap_open,
        gap_extend=gap_extend, device=device)))

    n = same = higher = lower = c1 = c2 = c3 = fn = 0
    for (i1, i2) in pairs:
        matched = False
        for h in hovls:
            if h[0] == i1 and h[3] == i2:
                matched = True
                h[12] = 1
                n += 1
                rs = h[10]
                ps = exact[(i1, i2, h[11])]
                if rs == ps:
                    same += 1
                elif rs > ps:
                    higher += 1
                    c1 += rs - ps < 50
                    c2 += rs - ps < 200
                else:
                    lower += 1
                    c3 += ps - rs < 20
        if not matched:
            fn += 1
    fp = sum(1 for h in hovls if h[12] == 0)
    return ScoreEvalResult(
        n_theoretical=len(pairs), n_matched=n, same_score=same,
        higher_score=higher, lower_score=lower, c1=c1, c2=c2, c3=c3,
        fn=fn, fp=fp)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="darwin_tpu_torch.eval.score_eval",
                                description=__doc__.splitlines()[0])
    p.add_argument("overlaps")
    p.add_argument("reference")
    p.add_argument("reads")
    p.add_argument("--min-overlap", type=int, default=1000)
    p.add_argument("--params", default=None)
    p.add_argument("--device", default="cuda",
                   help="device of the exact scorer (default cuda, which "
                        "must be present; cpu runs its plain version)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device is available",
              file=sys.stderr)
        return 2
    prm = Params.from_cfg(args.params) if args.params else Params()
    r1 = parse_fasta(args.reference)
    r2 = parse_fasta(args.reads)
    with open(args.overlaps) as f:
        records = [line for line in f.read().splitlines() if line]
    res = evaluate_scores(
        records, [r.name for r in r1], [r.name for r in r2],
        [r.seq for r in r1], [r.seq for r in r2],
        match=prm.match, mismatch=prm.mismatch, gap_open=prm.gap_open,
        gap_extend=prm.gap_extend, min_overlap=args.min_overlap,
        device=device)
    print(f"num theoretical ovls: {res.n_theoretical}")
    print(f"n: {res.n_matched}")
    print(f"same score: {res.same_score}")
    print(f"higher score: {res.higher_score}")
    print(f"lower score: {res.lower_score}")
    print(f"c1: {res.c1}")
    print(f"c2: {res.c2}")
    print(f"c3: {res.c3}")
    print(f"FN: {res.fn}")
    print(f"FP: {res.fp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
