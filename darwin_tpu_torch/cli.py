"""darwin-compatible command line interface of the PyTorch port.

Usage (positional args mirror the reference, darwin.cpp:451-507, and
darwin_tpu.cli):

    python -m darwin_tpu_torch.cli <REF>.fasta <READS>.fasta [NUM_RANGES] \
        [NUM_BLOCKS THREADS_PER_BLOCK] [options]

Reads are split into NUM_RANGES contiguous ranges, each writing its own
``darwin.<i>.out``; NUM_BLOCKS x THREADS_PER_BLOCK is the slot count
unless --batch-size is given.  Reads ``params.cfg`` from the working
directory like the reference, or from --params.  The GACT loop runs on
--device (default cuda); there is no fallback to another device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from darwin_tpu.config import Params
from darwin_tpu.index.genome import Genome
from darwin_tpu.index.seed_table import SeedTable
from darwin_tpu.io.fasta import parse_fasta
from darwin_tpu_torch.pipeline import (format_records, make_merged_engine,
                                       read_banks, run_device_merged)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="darwin-tpu-torch",
        description="D-SOFT + GACT long-read overlapper (PyTorch/CUDA)")
    p.add_argument("reference", help="reference FASTA")
    p.add_argument("reads", help="reads FASTA")
    p.add_argument("num_ranges", type=int, nargs="?", default=1,
                   help="number of darwin.<i>.out output ranges")
    p.add_argument("num_blocks", type=int, nargs="?", default=None)
    p.add_argument("threads_per_block", type=int, nargs="?", default=None)
    p.add_argument("--params", default="params.cfg",
                   help="params.cfg path (reference-compatible INI)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="GACT slot count (overrides blocks*tpb)")
    p.add_argument("--out-dir", default=".",
                   help="directory for darwin.<i>.out files")
    p.add_argument("--merged-out", default=None,
                   help="also write a sorted-unique merged overlap file")
    p.add_argument("--seed-table", default=None,
                   help="seed table cache path (.npz); built if missing")
    p.add_argument("--noscore", action="store_true",
                   help="skip rescoring (reference NOSCORE build)")
    p.add_argument("--threads", type=int, default=None,
                   help="host threads for the native D-SOFT engine "
                        "(default: all cores)")
    p.add_argument("--metrics-json", default=None,
                   help="write phase timings/counters as JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device of the GACT loop (default cuda)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device is available",
              file=sys.stderr)
        return 2
    params = (Params.from_cfg(args.params) if Path(args.params).exists()
              else Params())
    same_file = args.reference == args.reads
    print(f"same_file: {int(same_file)}")
    if args.batch_size:
        batch_size = args.batch_size
    elif args.num_blocks and args.threads_per_block:
        batch_size = args.num_blocks * args.threads_per_block
    else:
        batch_size = 512
    print(f"Scores: match = {params.match}, mismatch = {params.mismatch},"
          f" gap_open = {params.gap_open}, gap_extend = {params.gap_extend}")
    print(f"Batch size: {batch_size}, output ranges: {args.num_ranges}, "
          f"device: {device}")
    metrics: dict = {"batch_size": batch_size, "device": str(device)}

    t_start = time.perf_counter()
    ref_records = parse_fasta(args.reference)
    genome = Genome(ref_records, params.bin_size)
    read_records = (ref_records if same_file
                    else parse_fasta(args.reads))
    metrics["num_reads"] = len(read_records)
    print(f"Reference length: {genome.total_length}, "
          f"{len(ref_records)} pieces; number of reads: "
          f"{len(read_records)}")

    fwd_bank, rev_bank = read_banks(read_records)
    prebuilt = make_merged_engine(
        genome, fwd_bank, rev_bank, params, same_file=same_file,
        batch_size=batch_size, compute_score=not args.noscore,
        device=device)

    t0 = time.perf_counter()
    if args.seed_table and Path(args.seed_table).exists():
        table = SeedTable.load(args.seed_table)
        print(f"Seed table loaded from {args.seed_table}")
    else:
        table = SeedTable.build(genome.concat, params.seed_size,
                                params.seed_occurence_multiple,
                                params.bin_size, params.window_size)
        if args.seed_table:
            table.save(args.seed_table)
        print(f"Seed table built: {len(table.pos)} minimizers")
    metrics["seed_table_s"] = time.perf_counter() - t0

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    num_reads = len(read_records)
    per = max(1, -(-num_reads // max(1, args.num_ranges)))
    all_lines: list[str] = []
    n_cand = 0
    for range_id, lo in enumerate(range(0, num_reads, per)):
        hi = min(num_reads, lo + per)
        recs, cc = run_device_merged(
            genome, table, fwd_bank, rev_bank, params,
            same_file=same_file, batch_size=batch_size,
            compute_score=not args.noscore, read_ids=range(lo, hi),
            num_threads=args.threads, prebuilt=prebuilt,
            metrics=metrics)
        n_cand += sum(cc)
        print(f"range {range_id}: {cc[0]}+{cc[1]} candidates")
        lines = format_records(genome, read_records, recs)
        (out_dir / f"darwin.{range_id}.out").write_text(
            "".join(line + "\n" for line in lines))
        all_lines.extend(lines)

    wall = time.perf_counter() - t_start
    print(f"Time finding seeds: {metrics.get('seed_s', 0.0) * 1e3:.0f} "
          f"msec")
    print(f"Time GACT calling: {metrics.get('align_s', 0.0) * 1e3:.0f} "
          f"msec")
    if args.merged_out:
        merged = sorted(set(all_lines))
        Path(args.merged_out).write_text(
            "".join(line + "\n" for line in merged))
        print(f"Merged {len(all_lines)} records -> {len(merged)} unique "
              f"in {args.merged_out}")
    if args.metrics_json:
        metrics.update(
            wall_s=wall, num_candidates=n_cand,
            num_records=len(all_lines),
            reads_per_s=num_reads / max(1e-9, metrics.get("seed_s", 0.0)
                                        + metrics.get("align_s", 0.0)))
        Path(args.metrics_json).write_text(
            json.dumps(metrics, indent=2) + "\n")
        print(f"Metrics written to {args.metrics_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
