"""Human-scale coordinate dry run of the port: a reference past 2^31
bases.

The counterpart of tools/bigcoord_dryrun.py.  It builds a multi-piece
random reference just beyond 2^31 bases in all (each piece below 2^31,
like real chromosomes), samples reads from the last piece (global
origins past 2^31), and drives the port's pipeline: the native
seed-table build, D-SOFT (--dsoft host: the native library, int64 hits;
device: collect_calls_device, the table's positions as uint32 lanes),
the global to (piece, local) decode, and GACT (--engine device: the
merged-strand DeviceGactEngine, whose banks past 2^31 bytes the span
fetch addresses with int64 offsets; host: run_gact_batch over
TorchTileAligner).  It asserts what the original asserts: the last piece
starts past 2^31, the table's largest position is past 2^31, every
read's origin is among its candidates in the last piece, and every read
re-maps to its origin.

--filler N makes every piece but the last all N.  The coordinates are the
same, and only the last piece is random sequence: its minimizers and
one hash for the N windows (the reference's coding of N), which the
occurrence cap drops from every lookup.  Without it the pieces are
random, as in the original.

Usage: python tools/torch_bigcoord_dryrun.py [--gb 2.4] [--pieces 10]
         [--reads 4] [--read-len 8000] [--engine host|device]
         [--dsoft host|device] [--filler N] [--batch 64]
         [--device cuda|cpu]
(--gb 2.4 takes minutes: about 2.5 GB of sequence, the table, seeding.)
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import darwin_tpu_torch  # noqa: F401,E402  (THP madvise guard)
import numpy as np  # noqa: E402

_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCAtgca"):
    _COMP[_a] = _b


def revcomp_codes(arr: np.ndarray) -> np.ndarray:
    return _COMP[arr[::-1]]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gb", type=float, default=2.4)
    ap.add_argument("--pieces", type=int, default=10)
    ap.add_argument("--reads", type=int, default=4)
    ap.add_argument("--read-len", type=int, default=8000)
    ap.add_argument("--engine", choices=("host", "device"), default="host")
    ap.add_argument("--dsoft", choices=("host", "device"), default="host")
    ap.add_argument("--filler", choices=("N",), default=None,
                    help="fill every piece but the last with this base")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args, params, log=print) -> dict:
    """The pieces, genome, seed table and reads of a dry run, the
    original's asserts on the coordinates checked.  Returns {pieces,
    genome, table, reads (ASCII uint8 arrays), origins, big}."""
    from darwin_tpu_torch.index.genome import Genome
    from darwin_tpu_torch.index.seed_table import SeedTable
    from darwin_tpu_torch.io.fasta import FastaRecord

    total = int(args.gb * (1 << 30))
    per = total // args.pieces
    rng = np.random.default_rng(31)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)

    t0 = time.perf_counter()
    pieces = []
    for i in range(args.pieces):
        if args.filler and i < args.pieces - 1:
            seq = args.filler * per
        else:
            seq = alpha[rng.integers(0, 4, size=per)].tobytes().decode()
        pieces.append(FastaRecord([f"chr{i}"], seq))
    log(f"genome: {args.pieces} x {per / 1e6:.1f} Mb = "
        f"{total / 2**31:.3f} x 2^31 bases"
        + (f" (all but the last piece {args.filler})" if args.filler else "")
        + f" ({time.perf_counter() - t0:.1f} s)")

    big = total > 2**31  # a small --gb is a smoke of the same code path
    t0 = time.perf_counter()
    genome = Genome(pieces, params.bin_size)
    last_start = int(genome.chr_id_to_start_bin[-1]) * genome.bin_size
    if big and not last_start > 2**31:
        raise AssertionError(f"the last piece starts at {last_start}, not "
                             f"past 2^31")
    log(f"concat + maps: {time.perf_counter() - t0:.1f} s (last piece "
        f"starts at {last_start / 2**31:.4f} x 2^31)")

    t0 = time.perf_counter()
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size)
    max_pos = int(table.pos.max())
    if big and not max_pos > 2**31:
        raise AssertionError("the table's positions stayed below 2^31")
    log(f"seed table: {len(table.pos) / 1e6:.3f} M minimizers, max pos "
        f"{max_pos / 2**31:.4f} x 2^31 ({time.perf_counter() - t0:.1f} s)")

    # Reads sampled from the last piece: global origins past 2^31.
    reads, origins = [], []
    gl = np.frombuffer(pieces[-1].seq.encode(), dtype=np.uint8)
    for _ in range(args.reads):
        s = int(rng.integers(0, per - args.read_len))
        chunk = gl[s:s + args.read_len].copy()
        mut = rng.random(args.read_len) < 0.05
        chunk[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
        reads.append(chunk)
        origins.append(s)
    return dict(pieces=pieces, genome=genome, table=table, reads=reads,
                origins=origins, big=big)


def remap(b: dict, params, *, engine: str, dsoft: str, batch: int, device,
          log=print) -> list:
    """D-SOFT and GACT of a build()'s reads on device; asserts that every
    read's origin is among its candidates in the last piece and that
    every read re-maps to it.  Returns the records."""
    from darwin_tpu_torch.engine.batch import run_gact_batch
    from darwin_tpu_torch.engine.scoring import ScoreParams
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.pipeline import (collect_calls, collect_calls_device,
                                           make_aligner, run_device_merged)

    genome, table, reads, origins = (b["genome"], b["table"], b["reads"],
                                     b["origins"])
    bank = SeqBank(reads)
    t0 = time.perf_counter()
    if dsoft == "device":
        calls = collect_calls_device(table, genome, bank, params,
                                     device=device)
    else:
        calls = collect_calls(table, genome, bank, params)
    log(f"D-SOFT ({dsoft}): {len(calls.ref_id)} candidates "
        f"({time.perf_counter() - t0:.1f} s)")
    last = len(b["pieces"]) - 1
    # Spurious same-diagonal collisions are expected on gigabases of
    # random sequence; the true origin must be among every read's
    # candidates, decoded into the last piece.
    for r in range(len(reads)):
        mine = (calls.query_id == r) & (calls.ref_id == last)
        near = mine & (np.abs(calls.ref_pos - calls.query_pos - origins[r])
                       < 100)
        if not near.any():
            raise AssertionError(f"read {r}: origin candidate missing")

    t0 = time.perf_counter()
    if engine == "device":
        rev_bank = SeqBank([revcomp_codes(r) for r in reads])
        recs, _ = run_device_merged(genome, table, bank, rev_bank, params,
                                    same_file=False, batch_size=batch,
                                    dsoft=dsoft, device=device)
    else:
        sp = ScoreParams(params.match, params.mismatch, params.gap_open,
                         params.gap_extend)
        recs = run_gact_batch(
            genome, bank, calls, tile_size=params.tile_size,
            first_tile_score_threshold=params.first_tile_score_threshold,
            sp=sp, complement=False, same_file=False,
            aligner=make_aligner(params, device), batch_size=batch)
    log(f"GACT ({engine}): {len(recs)} records "
        f"({time.perf_counter() - t0:.1f} s)")
    ok = 0
    read_len = [len(r) for r in reads]
    for r in range(len(reads)):
        cand = [x for x in recs if x.query_id == r]
        hit = any(abs(x.ab - origins[r] - (x.bb - 1)) < 100
                  and x.ae - x.ab > 0.9 * read_len[r] for x in cand)
        ok += hit
        log(f"  read {r}: origin chr{last}:{origins[r]} -> {len(cand)} "
            f"records, remapped={hit}")
    if ok != len(reads):
        raise AssertionError("some reads failed to re-map")
    return recs


def run(args, params) -> int:
    from darwin_tpu_torch.lab import resolve_device
    from torch_mem_usage import host_memory_line, memory_line

    device = resolve_device(args.device)
    print(host_memory_line(), flush=True)
    b = build(args, params, log=lambda s: print(s, flush=True))
    remap(b, params, engine=args.engine, dsoft=args.dsoft, batch=args.batch,
          device=device, log=lambda s: print(s, flush=True))
    print(memory_line(device), flush=True)
    where = ("past 2^31 global positions" if b["big"]
             else "(small-scale smoke; pass --gb 2.4 for >2^31)")
    print(f"BIGCOORD DRYRUN OK: seeding, decode and alignment are exact "
          f"{where}", flush=True)
    return 0


def main(argv=None) -> int:
    from darwin_tpu_torch.config import Params

    return run(parse_args(argv), Params())


if __name__ == "__main__":
    sys.exit(main())
