"""Resident serving on the port: the seed table, the banks and the
engine stay resident, and read batches go through seeding and
alignment only.

The counterpart of tools/resident_serve.py.  A deployment holds the
reference's seed table and the device engine (its banks on the card)
in a long-lived process and pays only D-SOFT and GACT a query batch:
pipeline.make_merged_engine once, then pipeline.run_device_merged with
prebuilt= a batch.  The reads are one fixed batch, as in the original.
Each of REPS batches prints its wall time, seed_s, align_s and reads/s
(--dsoft device: seeded by the device D-SOFT, whose index is built with
the first batch and stays resident on the table);
every batch's record set must equal the first batch's and that of one
run_pipeline call on the same inputs, else the exit code is 1.

Usage: python tools/torch_resident_serve.py [GENOME_BP] [N_READS] [REPS]
           [--device cuda|cpu] [--dsoft host|device]
       (defaults: 4.6 Mb, 460 reads, 3: the E.coli shape; 3e9 300 for
        the human-scale row, the genome in pieces of 125 Mb)
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

PIECE_BP = 125_000_000


def dataset(G: int, NR: int, read_len: int = 10_000):
    """tools/resident_serve.py's dataset: a G bp genome in
    max(1, G // PIECE_BP) random pieces and NR reads of read_len bases
    (10 kb there) at 12% error sampled piece by piece (numpy seed 42).
    Returns (reference records, read records)."""
    from darwin_tpu_torch.eval.datagen import sample_reads, synth_genome
    from darwin_tpu_torch.io.fasta import FastaRecord

    rng = np.random.default_rng(42)
    n_chr = max(1, G // PIECE_BP)
    chroms = [synth_genome(G // n_chr, rng) for _ in range(n_chr)]
    reads = []
    for c in chroms:
        reads += sample_reads(c, NR // n_chr + 1, read_len, rng,
                              error_rate=0.12, rc_fraction=0.5)
    return ([FastaRecord([f"chr{i}"], c) for i, c in enumerate(chroms)],
            [FastaRecord([n], s) for n, s in reads[:NR]])


def serve(ref_records, read_records, params, *, same_file: bool, reps: int,
          batch_size: int = 512, device="cuda", dsoft: str = "host",
          log=print) -> dict:
    """The resident loop: the genome, seed table and engine built once,
    then a first batch and reps more through run_device_merged(prebuilt=).
    Returns {"batches": [{wall_s, seed_s, align_s, reads_per_s,
    records}], "first": the first batch's sorted-unique record lines};
    each batch's "records" is its sorted-unique lines."""
    import torch

    from darwin_tpu_torch.index.genome import Genome
    from darwin_tpu_torch.index.seed_table import SeedTable
    from darwin_tpu_torch.pipeline import (format_records, make_merged_engine,
                                           read_banks, run_device_merged)

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    genome = Genome(ref_records, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size)
    t1 = time.perf_counter()
    log(f"resident table build: {t1 - t0:.3f} s ({len(table.pos)} entries)")
    fwd, rev = read_banks(read_records)
    prebuilt = make_merged_engine(genome, fwd, rev, params,
                                  same_file=same_file, batch_size=batch_size,
                                  device=device)
    sync()
    t2 = time.perf_counter()
    log(f"resident engine build + bank upload: {t2 - t1:.3f} s")
    NR = len(read_records)

    def batch():
        m: dict = {}
        t = time.perf_counter()
        recs, _ = run_device_merged(genome, table, fwd, rev, params,
                                    same_file=same_file,
                                    batch_size=batch_size, dsoft=dsoft,
                                    prebuilt=prebuilt, metrics=m)
        lines = sorted(set(format_records(genome, read_records, recs)))
        sync()
        dt = time.perf_counter() - t
        return dict(wall_s=dt, seed_s=m["seed_s"], align_s=m["align_s"],
                    reads_per_s=NR / dt, records=lines)

    first = batch()
    log(f"first batch: {first['wall_s']:.3f} s, {len(first['records'])} "
        f"records")
    batches = []
    for i in range(reps):
        b = batch()
        batches.append(b)
        log(f"batch {i}: {b['wall_s']:.3f} s = {b['reads_per_s']:.1f} "
            f"reads/s (seed {b['seed_s'] * 1e3:.1f} + align "
            f"{b['align_s'] * 1e3:.1f} ms), {len(b['records'])} records, "
            f"equal to the first: {b['records'] == first['records']}")
    return dict(batches=batches, first=first["records"])


def check(ref_records, read_records, params, *, reps: int, device,
          dsoft: str = "host", log=print) -> int:
    """serve() over the reads as a guided batch, then one run_pipeline
    call on the same inputs; 0 when every batch's records equal the
    first batch's and the one-shot run's, else 1."""
    from darwin_tpu_torch.pipeline import run_pipeline

    out = serve(ref_records, read_records, params, same_file=False,
                reps=reps, device=device, dsoft=dsoft, log=log)
    t0 = time.perf_counter()
    one_shot = sorted(set(run_pipeline(
        ref_records, read_records, params, same_file=False, batch_size=512,
        dsoft=dsoft, device=device).records))
    log(f"one-shot run_pipeline: {time.perf_counter() - t0:.3f} s, "
        f"{len(one_shot)} records")
    bad = [i for i, b in enumerate(out["batches"])
           if b["records"] != out["first"]]
    if bad or out["first"] != one_shot:
        log(f"RESIDENT-SERVE FAILED: batches {bad} differ from the first, "
            f"or the first from the one-shot run "
            f"({out['first'] == one_shot})")
        return 1
    NR = len(read_records)
    best = min((b["wall_s"] for b in out["batches"]), default=float("nan"))
    log(f"RESIDENT-SERVE {sum(len(r.seq) for r in ref_records)} bp, {NR} "
        f"reads, {len(one_shot)} records: best {best:.3f} s = "
        f"{NR / best:.1f} reads/s; every batch equal to the one-shot run")
    return 0


def main(argv=None) -> int:
    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.lab import resolve_device
    from torch_mem_usage import host_memory_line, memory_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("genome_bp", nargs="?", default="4.6e6")
    ap.add_argument("n_reads", nargs="?", type=int, default=460)
    ap.add_argument("reps", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dsoft", choices=("host", "device"), default="host")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    G, NR = int(float(args.genome_bp)), args.n_reads
    params = Params.from_cfg(str(REPO / "configs" / "tpu.cfg"))
    print(host_memory_line(), flush=True)
    t0 = time.perf_counter()
    ref_records, read_records = dataset(G, NR)
    print(f"genome {G} bp as {len(ref_records)} pieces, {NR} reads: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rc = check(ref_records, read_records, params, reps=args.reps,
               device=device, dsoft=args.dsoft,
               log=lambda s: print(s, flush=True))
    print(memory_line(device), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
