"""Seeded scale differential of the port: a PBSIM-style dataset through
darwin_tpu_torch.pipeline.run_pipeline, held to an expected record set.

The counterpart of tools/scale_test.py.  The dataset flags and the
generator are the same, so one seed gives byte-identical genome.fasta
and reads.fasta.  A dataset already in --workdir that was made with the
same flags is reused.  The run goes through run_pipeline on --device
(default cuda; fails without a card unless given cpu) with --engine and
--dsoft: one cold run, then the best of --warm warm runs.  It prints
reads/s, the unique records, peak host RSS and peak device memory, and
the records' sensitivity and specificity from the reads' names
(eval/sensitivity.py; --guided takes its +/-50 bp mode, one chromosome
at a time, since read ids restart in each).

There is no reference binary on the card's host, so --expect FILE (a
sorted-unique record file: ours.darwin of a scale_test.py run, or the
ref.darwin its --only ref phase leaves) takes the place of --darwin.
The run ends in ``PARITY: EXACT (n records)`` (exit 0) or ``PARITY:
FAILED missing= extra=`` (exit 1); without --expect it skips the
differential and exits 0.

Usage:
    python tools/torch_scale_test.py [--genome 4600000] [--reads 460]
        [--read-len 10000] [--read-len-min 0] [--error 0.12] [--seed 42]
        [--guided [--chromosomes C]] [--params P] [--batch-size 2048]
        [--engine device|host] [--dsoft host|device] [--expect FILE]
        [--warm 2] [--device cuda|cpu] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import darwin_tpu_torch  # noqa: F401,E402  (THP madvise guard)
import numpy as np  # noqa: E402

DATASET_FLAGS = ("genome", "reads", "read_len", "read_len_min", "error",
                 "seed", "guided", "chromosomes")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--genome", type=int, default=4_600_000)
    p.add_argument("--reads", type=int, default=460)
    p.add_argument("--read-len", type=int, default=10_000)
    p.add_argument("--read-len-min", type=int, default=0,
                   help="draw each read's length uniformly from "
                        "[min, read-len]; 0 = fixed-length reads")
    p.add_argument("--error", type=float, default=0.12)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--guided", action="store_true",
                   help="reads against the genome instead of "
                        "self-overlap")
    p.add_argument("--chromosomes", type=int, default=1,
                   help="split the genome into C FASTA records (guided "
                        "only): each piece's positions stay below the "
                        "reference binary's int ref_pos limit at 3 Gb")
    p.add_argument("--params", default=None,
                   help="params.cfg (default: the reference's defaults)")
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--engine", choices=("device", "host"), default="device")
    p.add_argument("--dsoft", choices=("host", "device"), default="host")
    p.add_argument("--expect", default=None,
                   help="sorted-unique record file to diff against")
    p.add_argument("--warm", type=int, default=2,
                   help="warm runs after the cold one (best is kept)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--workdir",
                   default=str(Path(tempfile.gettempdir())
                               / "torch_scale_test"))
    return p.parse_args(argv)


def make_dataset(args, work: Path) -> tuple[Path, Path]:
    """(reads.fasta, reference FASTA) in work, made as tools/scale_test.py
    makes them (the same rng draws in the same order), or reused when
    work's dataset.json names the same flags."""
    from darwin_tpu_torch.eval.datagen import sample_reads, synth_genome
    from darwin_tpu_torch.io.fasta import write_fasta

    fasta = work / "reads.fasta"
    ref_fasta = (work / "genome.fasta") if args.guided else fasta
    stamp = work / "dataset.json"
    flags = {f: getattr(args, f) for f in DATASET_FLAGS}
    if (stamp.exists() and json.loads(stamp.read_text()) == flags
            and fasta.exists() and ref_fasta.exists()):
        return fasta, ref_fasta
    stamp.unlink(missing_ok=True)
    rng = np.random.default_rng(args.seed)
    lr = (args.read_len_min, args.read_len) if args.read_len_min else None
    C = max(1, args.chromosomes)
    if C > 1:
        if not args.guided:
            raise ValueError("--chromosomes needs --guided")
        chroms, reads = [], []
        for c in range(C):
            n = args.genome // C
            r = args.reads // C + (1 if c < args.reads % C else 0)
            g = synth_genome(n, rng)
            chroms.append((f"chr{c}", g))
            for name, seq in sample_reads(
                    g, r, args.read_len, rng, error_rate=args.error,
                    rc_fraction=0.5, read_len_range=lr):
                reads.append((f"c{c}{name}", seq))
        write_fasta(fasta, reads)
        write_fasta(ref_fasta, chroms)
    else:
        genome = synth_genome(args.genome, rng)
        reads = sample_reads(genome, args.reads, args.read_len, rng,
                             error_rate=args.error, rc_fraction=0.5,
                             read_len_range=lr)
        write_fasta(fasta, reads)
        if args.guided:
            write_fasta(ref_fasta, [("genome_0", genome)])
    stamp.write_text(json.dumps(flags))
    return fasta, ref_fasta


def sensitivity(records: list[str], read_names: list[str], guided: bool):
    """eval/sensitivity.py's EvalResult of the records against the
    coordinates in the reads' names.  Guided reads named c<C>R<i>_...
    (--chromosomes) are scored one chromosome at a time, their records
    grouped by the read's chromosome, and the counts summed."""
    from darwin_tpu_torch.eval.sensitivity import (
        EvalResult, measure_sensitivity, measure_sensitivity_guided)

    if not guided:
        return measure_sensitivity(records, read_names)

    def chrom(read_name: str) -> str:
        m = re.match(r"c(\d+)R", read_name)
        return m.group(1) if m else ""

    names, recs = {}, {}
    for n in read_names:
        names.setdefault(chrom(n), []).append(n)
    for line in records:
        read = line.split("query_id: ", 1)[1].split(",", 1)[0]
        recs.setdefault(chrom(read), []).append(line)
    total = EvalResult(0, 0, 0)
    for c, ns in names.items():
        r = measure_sensitivity_guided(recs.get(c, []), len(ns))
        total = EvalResult(total.tp + r.tp, total.fn + r.fn,
                           total.fp + r.fp)
    return total


def run(args) -> dict:
    """The dataset through run_pipeline, cold then --warm warm runs;
    returns the numbers it prints, with the sorted-unique records."""
    import torch

    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.io.fasta import parse_fasta
    from darwin_tpu_torch.lab import resolve_device
    from darwin_tpu_torch.pipeline import run_pipeline
    from torch_mem_usage import host_memory_line, memory_line, peak_device_gb

    device = resolve_device(args.device)
    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    print(host_memory_line(), flush=True)
    t0 = time.perf_counter()
    fasta, ref_fasta = make_dataset(args, work)
    print(f"dataset: {args.reads} x {args.read_len} bp reads over "
          f"{args.genome} bp genome -> {fasta}"
          + (f" (guided: vs the genome in {max(1, args.chromosomes)} "
             f"pieces)" if args.guided else "")
          + f", {time.perf_counter() - t0:.1f} s", flush=True)

    params = Params.from_cfg(args.params) if args.params else Params()
    records = parse_fasta(fasta)
    ref_recs = parse_fasta(ref_fasta) if args.guided else records
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def once():
        m: dict = {}
        t = time.perf_counter()
        res = run_pipeline(ref_recs, records, params,
                           same_file=not args.guided,
                           batch_size=args.batch_size, engine=args.engine,
                           dsoft=args.dsoft, device=device, metrics=m)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return res, time.perf_counter() - t, m

    res, cold, cold_m = once()
    warm, warm_m = cold, cold_m
    if args.warm:
        res, warm, warm_m = min((once() for _ in range(args.warm)),
                                key=lambda r: r[1])
    ours = sorted(set(res.records))
    (work / "ours.darwin").write_text("".join(x + "\n" for x in ours))
    ev = sensitivity(ours, [r.name for r in records], args.guided)
    out = dict(
        engine=args.engine, dsoft=args.dsoft, device=str(device),
        genome=args.genome, chromosomes=max(1, args.chromosomes),
        reads=args.reads, records=len(ours), cold_s=cold,
        warm_s=warm if args.warm else None,
        reads_per_s=args.reads / warm,
        reads_per_s_seed_align=args.reads / (warm_m["seed_s"]
                                             + warm_m["align_s"]),
        table_s=warm_m["table_s"], seed_s=warm_m["seed_s"],
        align_s=warm_m["align_s"],
        dsoft_index_s=warm_m.get("dsoft_index_s"),
        cold_table_s=cold_m["table_s"], cold_seed_s=cold_m["seed_s"],
        cold_dsoft_index_s=cold_m.get("dsoft_index_s"),
        dsoft_overflow_reads=warm_m.get("dsoft_overflow_reads"),
        engine_iters=warm_m.get("engine_iters"),
        sensitivity=ev.sensitivity, specificity=ev.specificity,
        tp=ev.tp, fn=ev.fn, fp=ev.fp, peak_device_gb=peak_device_gb(device),
        records_list=ours)
    print(f"darwin_tpu_torch ({args.engine} engine, {args.dsoft} D-SOFT, "
          f"{device}): cold {cold:.3f} s"
          + (f", warm {warm:.3f} s" if args.warm else "")
          + f" ({out['reads_per_s']:.1f} reads/s; "
          f"{out['reads_per_s_seed_align']:.1f} over seed_s + align_s), "
          f"{len(ours)} unique records", flush=True)
    print(f"  seed table {out['table_s']:.3f} s, seed_s {out['seed_s']:.3f}, "
          f"align_s {out['align_s']:.3f}"
          + (f", two-level index {out['dsoft_index_s']:.3f} s (cold run "
             f"{out['cold_dsoft_index_s']:.3f} s), overflowed reads "
             f"{out['dsoft_overflow_reads']}"
             if out["dsoft_index_s"] is not None else ""), flush=True)
    print(f"sensitivity {ev.sensitivity:.6f}, specificity "
          f"{ev.specificity:.6f} (TP {ev.tp}, FN {ev.fn}, FP {ev.fp}"
          + (", +/-50 bp" if args.guided else "") + ")", flush=True)
    print(memory_line(device), flush=True)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    ours = out.pop("records_list")
    print("RESULT " + json.dumps(out), flush=True)
    if not args.expect:
        print("no expected record file given (--expect); skipping "
              "differential")
        return 0
    want = sorted(set(Path(args.expect).read_text().splitlines()) - {""})
    if ours == want:
        print(f"PARITY: EXACT ({len(ours)} records)")
        return 0
    missing = set(want) - set(ours)
    extra = set(ours) - set(want)
    print(f"PARITY: FAILED missing={len(missing)} extra={len(extra)}")
    for line in sorted(missing)[:3]:
        print(f"  missing: {line}")
    for line in sorted(extra)[:3]:
        print(f"  extra:   {line}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
