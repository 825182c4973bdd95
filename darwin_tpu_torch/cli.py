"""darwin-compatible command line interface of the PyTorch port.

Usage (positional args mirror the reference, darwin.cpp:451-507, and
darwin_tpu.cli):

    python -m darwin_tpu_torch.cli <REF>.fasta <READS>.fasta [NUM_RANGES] \
        [NUM_BLOCKS THREADS_PER_BLOCK] [options]

Reads are split into NUM_RANGES contiguous ranges, each writing its own
``darwin.<i>.out`` (and ``darwin.<i>.paf`` with --paf-out);
NUM_BLOCKS x THREADS_PER_BLOCK is the slot count unless --batch-size is
given.  Reads ``params.cfg`` from the working directory like the
reference, or from --params.  The GACT loop runs on --device (default
cuda); there is no fallback to another device.  darwin_tpu.cli's
--backend and --jax-cache have no counterpart: --device takes
--backend's role, and the port compiles no XLA program.

--mesh N shards the device engine over N devices (parallel/mesh.py):
the first N visible CUDA devices, or with --device cpu N CPU entries;
fewer visible CUDA devices than N is an error.  --distributed makes
this process one rank of a torch.distributed job (gloo; torchrun's
MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK): it aligns its
read_range and writes darwin.<rank>.out, --merged-out and --paf-out are
gathered over the ranks, and with --seed-table rank 0 builds the table
and the other ranks load it (parallel/distributed.py).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import torch

from darwin_tpu_torch import native
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.io.fasta import iter_fasta, parse_fasta
from darwin_tpu_torch.io.paf import paf_lines
from darwin_tpu_torch.parallel import distributed as dist
from darwin_tpu_torch.parallel.mesh import make_mesh
from darwin_tpu_torch.pipeline import (format_records, make_aligner,
                                       make_merged_engine, read_banks,
                                       run_device_merged, run_host)


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
    p.add_argument("--engine", default="auto",
                   choices=["auto", "device", "host"],
                   help="device = whole GACT loop on --device; host = "
                        "slot loop on the host, each iteration's tiles "
                        "aligned on --device.  auto = device (darwin_tpu "
                        "picks host off the TPU because its device engine "
                        "is a long XLA compile; the port compiles none)")
    p.add_argument("--out-dir", default=".",
                   help="directory for darwin.<i>.out files")
    p.add_argument("--merged-out", default=None,
                   help="also write a sorted-unique merged overlap file")
    p.add_argument("--paf-out", default=None,
                   help="also write overlaps as PAF (sorted unique; "
                        "matches column is exact, 0 under --noscore), and "
                        "darwin.<i>.paf beside each darwin.<i>.out")
    p.add_argument("--seed-table", default=None,
                   help="seed table cache path (.npz); built if missing")
    p.add_argument("--noscore", action="store_true",
                   help="skip rescoring (reference NOSCORE build)")
    p.add_argument("--threads", type=int, default=None,
                   help="host threads for the native D-SOFT engine "
                        "(default: all cores)")
    p.add_argument("--chunk-reads", type=int, default=None,
                   help="stream the reads file in chunks of N records "
                        "(bounded memory; reads-vs-reference mode only)")
    p.add_argument("--resume", action="store_true",
                   help="skip read ranges whose darwin.<i>.out already "
                        "exists (restart amortization; the seed table "
                        "is amortized via --seed-table)")
    p.add_argument("--metrics-json", default=None,
                   help="write phase timings/counters as JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device of the GACT loop (default cuda)")
    p.add_argument("--dsoft", default="host", choices=["host", "device"],
                   help="seeding engine: host = native C++/NumPy, device "
                        "= D-SOFT on --device (dsoft/device.py)")
    p.add_argument("--mesh", type=int, default=None,
                   help="shard the device engine over N devices "
                        "(independent per-device slot pools): the first N "
                        "CUDA devices, or N CPU entries with --device cpu")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process mode (torch.distributed, gloo): this "
                        "process aligns its rank's read range and writes "
                        "darwin.<rank>.out; --merged-out and --paf-out "
                        "gather records across the ranks")
    return p


def _write_lines(path: Path, lines: list[str]) -> None:
    path.write_text("".join(line + "\n" for line in lines))


def _resume(kind: str, rid: int, out_file: Path, paf_file: Path,
            paf_out: str | None, all_lines: list, all_paf: list) -> None:
    """Take a finished range's (or chunk's) records from its files."""
    prior = out_file.read_text().splitlines()
    all_lines.extend(prior)
    if kind == "range":
        print(f"range {rid}: resumed from {out_file} ({len(prior)} records)")
    else:
        print(f"chunk {rid}: resumed ({len(prior)} records)")
    if paf_out:
        # PAF needs per-record data the .out text does not carry
        # (nmatch/ncols): take the sidecar the earlier --paf-out run
        # wrote beside the .out file.
        if paf_file.exists():
            all_paf.extend(paf_file.read_text().splitlines())
        else:
            print(f"WARNING: no {paf_file} sidecar; {kind} {rid} will be "
                  f"missing from {paf_out} (re-run without --resume to "
                  f"regenerate)", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    if args.distributed:
        dist.maybe_initialize()  # before anything else
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device is available",
              file=sys.stderr)
        return 2
    engine = "device" if args.engine == "auto" else args.engine
    mesh = None
    if args.mesh and engine == "device":
        try:
            mesh = (make_mesh(devices=[device] * args.mesh)
                    if device.type == "cpu" else make_mesh(args.mesh))
        except (RuntimeError, ValueError) as e:
            print(f"--mesh {args.mesh}: {e}", file=sys.stderr)
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
          f"device: {device}"
          + (f", mesh of {mesh.size}" if mesh else ""))
    # darwin_tpu.cli's keys (seconds as *_ms), and the port's own:
    # host_native says whether the host stages ran the native library or
    # their NumPy fallbacks; dsoft_overflow_reads counts the reads the
    # device D-SOFT's budgets sent to the host D-SOFT (0 on the host).
    metrics: dict = {"batch_size": batch_size, "device": str(device),
                     "engine": engine, "dsoft": args.dsoft,
                     "dsoft_overflow_reads": 0,
                     "host_native": native.available(),
                     "mesh_size": mesh.size if mesh else 1,
                     "world_size": dist.process_count()}

    t_start = time.perf_counter()
    ref_records = parse_fasta(args.reference)
    genome = Genome(ref_records, params.bin_size)
    metrics["ref_load_ms"] = (time.perf_counter() - t_start) * 1e3
    metrics["ref_length"] = int(genome.total_length)
    t0 = time.perf_counter()
    chunked = bool(args.chunk_reads) and not same_file
    if args.chunk_reads and same_file:
        print("--chunk-reads ignored: self-overlap mode needs the "
              "whole read set in memory (it IS the reference)")
    if chunked:
        read_records = None
        print(f"Reference length: {genome.total_length}, "
              f"{len(ref_records)} pieces; streaming reads in chunks of "
              f"{args.chunk_reads}")
    else:
        read_records = (ref_records if same_file
                        else parse_fasta(args.reads))
        metrics["num_reads"] = len(read_records)
        print(f"Reference length: {genome.total_length}, "
              f"{len(ref_records)} pieces; number of reads: "
              f"{len(read_records)}")
    metrics["read_load_ms"] = (0.0 if chunked
                               else (time.perf_counter() - t0) * 1e3)

    num_reads = 0 if chunked else len(read_records)
    if args.distributed:
        rng = dist.read_range(num_reads)
        ranges = [(dist.process_index(), rng.start, rng.stop)]
        print(f"distributed: process {dist.process_index()}/"
              f"{dist.process_count()}, reads [{rng.start}, {rng.stop})")
    else:
        per = max(1, -(-num_reads // max(1, args.num_ranges)))
        ranges = [(i, lo, min(num_reads, lo + per))
                  for i, lo in enumerate(range(0, num_reads, per))]
    out_dir = Path(args.out_dir)
    # Every range already has its output: skip the banks and the engine
    # (the loop below resumes them all).
    all_resumed = args.resume and not chunked and all(
        (out_dir / f"darwin.{rid}.out").exists() for rid, _, _ in ranges)
    fwd_bank = rev_bank = prebuilt = aligner = None
    if not chunked and not all_resumed:
        fwd_bank, rev_bank = read_banks(read_records)
        if engine == "device":
            prebuilt = make_merged_engine(
                genome, fwd_bank, rev_bank, params, same_file=same_file,
                batch_size=batch_size, compute_score=not args.noscore,
                device=device, mesh=mesh)
    if engine == "host":
        aligner = make_aligner(params, device)
    print(f"Engine: {engine}")

    t0 = time.perf_counter()
    if args.seed_table and dist.process_count() > 1:
        # Rank 0 builds (or reuses) the table on shared storage; the
        # others wait at the barrier and load it.
        table = None
        if dist.process_index() == 0 and not Path(args.seed_table).exists():
            table = SeedTable.build(genome.concat, params.seed_size,
                                    params.seed_occurence_multiple,
                                    params.bin_size, params.window_size,
                                    device=device)
            table.save(args.seed_table)
        dist.barrier("seed-table")
        if table is None:
            table = SeedTable.load(args.seed_table)
        print(f"Seed table ready (coordinator-built, {len(table.pos)} "
              f"minimizers)")
    elif args.seed_table and Path(args.seed_table).exists():
        table = SeedTable.load(args.seed_table)
        print(f"Seed table loaded from {args.seed_table}")
    else:
        table = SeedTable.build(genome.concat, params.seed_size,
                                params.seed_occurence_multiple,
                                params.bin_size, params.window_size,
                                device=device)
        if args.seed_table:
            table.save(args.seed_table)
        print(f"Seed table built: {len(table.pos)} minimizers")
    metrics["seed_table_s"] = time.perf_counter() - t0
    metrics["seed_table_ms"] = metrics["seed_table_s"] * 1e3

    out_dir.mkdir(parents=True, exist_ok=True)
    all_lines: list[str] = []
    all_paf: list[str] = []
    n_cand = 0

    def align(fwd, rev, read_ids=None):
        """Records and candidate counts of one read set (or of read_ids
        in it) on the engine."""
        kw = dict(same_file=same_file, batch_size=batch_size,
                  compute_score=not args.noscore, read_ids=read_ids,
                  num_threads=args.threads, dsoft=args.dsoft,
                  metrics=metrics)
        if engine == "device":
            return run_device_merged(genome, table, fwd, rev, params,
                                     prebuilt=prebuilt, device=device,
                                     mesh=mesh, **kw)
        return run_host(genome, table, fwd, rev, params, aligner=aligner,
                        **kw)

    def emit(recs, reads, out_file: Path, paf_file: Path) -> list[str]:
        lines = format_records(genome, reads, recs)
        _write_lines(out_file, lines)
        all_lines.extend(lines)
        if args.paf_out:
            pl = paf_lines(recs, genome, [r.name for r in reads],
                           [len(r.seq) for r in reads])
            _write_lines(paf_file, pl)
            all_paf.extend(pl)
        return lines

    if chunked:
        it = iter_fasta(args.reads)
        for chunk_id in itertools.count():
            chunk = list(itertools.islice(it, args.chunk_reads))
            if not chunk:
                break
            num_reads += len(chunk)
            out_file = out_dir / f"darwin.{chunk_id}.out"
            paf_file = out_dir / f"darwin.{chunk_id}.paf"
            if args.resume and out_file.exists():
                _resume("chunk", chunk_id, out_file, paf_file, args.paf_out,
                        all_lines, all_paf)
                continue
            # Each chunk's read banks differ: the device engine is built
            # for each (prebuilt stays None), over the one mesh; the
            # genome's bank was uploaded with the first and stays.
            recs, cc = align(*read_banks(chunk))
            n_cand += sum(cc)
            lines = emit(recs, chunk, out_file, paf_file)
            print(f"chunk {chunk_id}: {len(chunk)} reads, {len(lines)} "
                  f"records")
        metrics["num_reads"] = num_reads
    else:
        for range_id, lo, hi in ranges:
            out_file = out_dir / f"darwin.{range_id}.out"
            paf_file = out_dir / f"darwin.{range_id}.paf"
            if args.resume and out_file.exists():
                _resume("range", range_id, out_file, paf_file, args.paf_out,
                        all_lines, all_paf)
                continue
            recs, cc = align(fwd_bank, rev_bank, range(lo, hi))
            n_cand += sum(cc)
            print(f"range {range_id}: {cc[0]}+{cc[1]} candidates")
            emit(recs, read_records, out_file, paf_file)

    wall = time.perf_counter() - t_start
    print(f"Time finding seeds: {metrics.get('seed_s', 0.0) * 1e3:.0f} "
          f"msec")
    print(f"Time GACT calling: {metrics.get('align_s', 0.0) * 1e3:.0f} "
          f"msec")
    # sorted(set(...)), over every rank's records with --distributed.
    if args.paf_out:
        paf_merged = dist.allgather_records(all_paf)
        _write_lines(Path(args.paf_out), paf_merged)
        print(f"PAF written to {args.paf_out} ({len(paf_merged)} records)")
    if args.merged_out:
        merged = dist.allgather_records(all_lines)
        _write_lines(Path(args.merged_out), merged)
        print(f"Merged {len(all_lines)} records -> {len(merged)} unique "
              f"in {args.merged_out}")
    if args.metrics_json:
        metrics.update(
            wall_s=wall, num_candidates=n_cand,
            num_records=len(all_lines),
            seed_ms=metrics.get("seed_s", 0.0) * 1e3,
            gact_ms=metrics.get("align_s", 0.0) * 1e3,
            reads_per_s=num_reads / max(1e-9, metrics.get("seed_s", 0.0)
                                        + metrics.get("align_s", 0.0)))
        Path(args.metrics_json).write_text(
            json.dumps(metrics, indent=2) + "\n")
        print(f"Metrics written to {args.metrics_json}")
    if args.distributed:
        dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
