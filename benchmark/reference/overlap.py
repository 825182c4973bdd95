"""The plain reference's record set for a sample of reads.

Darwin's per-read flow (darwin.cpp:166-288, CPU build): D-SOFT on the
forward read and on its reverse complement, each candidate decoded to
(piece, position) through the bin maps and extended with GACT; a record
for every call that scores above 0, except a read against itself when the
reads are the reference (same_file).  A read's records depend only on the
read and the reference, so the records of a sample of reads are those
lines of the whole set whose query is in the sample.

Several samples (of several read sets, against their own references or
one shared reference) go through one batched GACT together: its rounds
are set by the longest call of all, not summed over the samples.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.reference.gact import gact
from benchmark.reference.seeds import Layout, SeedIndex, dsoft, minimizers
from benchmark.reference.seqio import revcomp


@dataclasses.dataclass
class Sample:
    """Reads (indices read_ids into reads) to align against pieces;
    same_file where the reads are the pieces."""
    pieces: list  # [(name, uint8 bases)]
    reads: list   # [(name, uint8 bases)]
    read_ids: list
    same_file: bool


def record_line(ref_name: str, query_name: str, ab: int, ae: int, bb: int,
                be: int, score: int, comp: int) -> str:
    """An overlap record as gact.cpp:213-224 writes it."""
    return (f"ref_id: {ref_name}, query_id: {query_name}, ab: {ab}, "
            f"ae: {ae}, bb: {bb}, be: {be}, score: {score}, comp: {comp}")


def _flat(seqs: list[np.ndarray], device):
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    flat = torch.from_numpy(np.concatenate(seqs) if seqs
                            else np.zeros(0, np.uint8)).to(device)
    return flat, starts, lens


def records_of_samples(samples: list[Sample], p: dict, device,
                       saturate: bool = False, stats: dict | None = None
                       ) -> list[list[str]]:
    """Each sample's record lines (see reference_records); stats, where
    given, gets the seconds of seeding and of GACT and GACT's counts."""
    t0 = time.perf_counter()
    device = torch.device(device)
    k, w = p["seed_size"], p["window_size"]
    strands, meta = [], []  # meta: (sample, read, comp)
    for si, s in enumerate(samples):
        for r in s.read_ids:
            seq = s.reads[int(r)][1]
            for comp, st in ((0, seq), (1, revcomp(seq))):
                strands.append(st)
                meta.append((si, int(r), comp))
    mins = []
    for seq in strands:
        o, h = minimizers(torch.from_numpy(seq).to(device), k, w,
                          reference=False)
        mins.append((o.cpu().numpy(), h.cpu().numpy()))
    # One index a distinct reference, over the hashes its samples carry;
    # the pieces of every distinct reference in one bank.
    refs: dict[int, dict] = {}
    for si, s in enumerate(samples):
        refs.setdefault(id(s.pieces), dict(pieces=s.pieces, strands=[]))
    for st, (si, _, _) in enumerate(meta):
        refs[id(samples[si].pieces)]["strands"].append(st)
    bank, first = [], 0
    for ref in refs.values():
        ref["first"] = first
        first += len(ref["pieces"])
        bank += [s for _, s in ref["pieces"]]
        ref["layout"] = Layout([s for _, s in ref["pieces"]], p["bin_size"])
        concat = ref["layout"].concat([s for _, s in ref["pieces"]], device)
        wanted = np.concatenate([mins[st][1] for st in ref["strands"]]
                                + [np.zeros(0, np.int64)])
        ref["index"] = SeedIndex(concat, wanted, p)
        del concat
    piece, strand, rpos, qpos = [], [], [], []
    for st, (o, h) in enumerate(mins):
        si, r, _ = meta[st]
        ref = refs[id(samples[si].pieces)]
        hits, offs = dsoft(ref["index"], o, h, p)
        pc, local = ref["layout"].decode(hits)
        if samples[si].same_file:
            keep = pc != r
            pc, local, offs = pc[keep], local[keep], offs[keep]
        piece.append(pc + ref["first"])
        rpos.append(local)
        qpos.append(offs)
        strand.append(np.full(len(pc), st, dtype=np.int64))
    cat = lambda xs: (np.concatenate(xs) if xs  # noqa: E731
                      else np.zeros(0, np.int64))
    piece, strand, rpos, qpos = map(cat, (piece, strand, rpos, qpos))
    rf, rs, rl = _flat(bank, device)
    qf, qs, ql = _flat(strands, device)
    t1 = time.perf_counter()
    out = gact(rf, rs, rl, qf, qs, ql, piece, strand, rpos, qpos, p,
               saturate=saturate, stats=stats)
    if stats is not None:
        stats.update(seed_s=t1 - t0, gact_s=time.perf_counter() - t1)
    names = [n for ref in refs.values() for n, _ in ref["pieces"]]
    lines: list[list[str]] = [[] for _ in samples]
    for (ab, ae, bb, be, score), pc, st in zip(out.tolist(), piece.tolist(),
                                               strand.tolist()):
        if score > 0:
            si, r, comp = meta[st]
            lines[si].append(record_line(names[pc], samples[si].reads[r][0],
                                         ab, ae, bb, be, score, comp))
    return lines


def reference_records(pieces: list[tuple[str, np.ndarray]],
                      reads: list[tuple[str, np.ndarray]], p: dict, *,
                      same_file: bool, read_ids, device,
                      saturate: bool = False) -> list[str]:
    """Every record whose query is one of read_ids (indices into reads),
    against the reference pieces [(name, uint8 bases)]."""
    return records_of_samples(
        [Sample(pieces, reads, list(read_ids), same_file)], p, device,
        saturate)[0]
