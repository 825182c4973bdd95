"""Multi-process scaling run of the port's CLI (torch.distributed, gloo).

    python3 tools/torch_scaling_run.py [--procs 2] [--genome 150000]
        [--reads 48] [--read-len 5000] [--seed 42] [--params P]
        [--batch-size 128] [--device cuda|cpu] [--workdir DIR]

The counterpart of tools/scaling_run.py.  On one generated dataset
(self-overlap, 10% error) it runs `python -m darwin_tpu_torch.cli` as
one process, then as --procs processes with --distributed, then as
--procs processes with --distributed and --seed-table (rank 0 builds the
table on shared storage, the other ranks wait at a barrier and load
it: the amortized run).  Each rank writes its own --metrics-json and
--merged-out.  The ranks find each other through torchrun's variables,
MASTER_ADDR (127.0.0.1), MASTER_PORT (a free port, picked anew for each
run), WORLD_SIZE and RANK; each process gets OMP_NUM_THREADS=1.  The
kernel library (on a card) and the native host library are built once
here, before any rank starts, so the ranks do not build them at once.

The three merges must be equal (``PARITY: EXACT``; otherwise
``PARITY: FAILED`` and exit 1).  Then it prints each run's wall and
reads/s, the work every rank repeats (parsing the reads, building or
loading the seed table: ref_load_ms + read_load_ms + seed_table_ms) and
the efficiency model of scaling_run.py: efficiency(N) ~= t_align /
(t_align / N + t_dup), with t_align the one process's seed_ms + gact_ms.

--device goes to every rank.  On one card every rank runs on cuda:0
(and on the same host cores), so the run measures the mechanism (the
duplicated work, the merge), not scaling; the output says so.  Without
a card and without --device cpu it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import darwin_tpu_torch  # noqa: F401,E402  (THP madvise guard)
import numpy as np  # noqa: E402

from darwin_tpu_torch.lab import add_device_arg, resolve_device  # noqa: E402

TIMEOUT_S = 3600


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--genome", type=int, default=150_000)
    ap.add_argument("--reads", type=int, default=48)
    ap.add_argument("--read-len", type=int, default=5_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--params", default=None,
                    help="params.cfg for the CLI (default: the "
                         "reference's defaults)")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--workdir",
                    default=str(Path(tempfile.gettempdir())
                                / "torch_scaling_run"))
    add_device_arg(ap)
    return ap.parse_args(argv)


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def run_cli(args, fasta: Path, tag: str, nprocs: int,
            extra_args=()) -> dict:
    """The CLI as nprocs processes (one without --distributed); returns
    {wall, metrics ([per rank]), merged (rank 0's --merged-out lines)}.
    Raises unless every process exits 0; kills the others then."""
    outdir = Path(args.workdir) / tag
    outdir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])}
    if nprocs > 1:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=free_port(),
                   WORLD_SIZE=str(nprocs))
    cmd = [sys.executable, "-m", "darwin_tpu_torch.cli", str(fasta),
           str(fasta), "--batch-size", str(args.batch_size),
           "--device", args.device, "--out-dir", str(outdir),
           *(["--params", str(Path(args.params).resolve())]
             if args.params else []), *extra_args,
           *(["--distributed"] if nprocs > 1 else [])]
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(nprocs):
            procs.append(subprocess.Popen(
                [*cmd, "--metrics-json", str(outdir / f"metrics.{rank}.json"),
                 "--merged-out", str(outdir / f"merged.{rank}.out")],
                cwd=outdir, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env={**env, "RANK": str(rank)}))
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            if p.returncode != 0:
                raise RuntimeError(f"{tag}: a process exited "
                                   f"{p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    metrics = [json.loads((outdir / f"metrics.{i}.json").read_text())
               for i in range(nprocs)]
    merged = (outdir / "merged.0.out").read_text().splitlines()
    return dict(wall=wall, metrics=metrics, merged=merged)


def build_libraries(device) -> None:
    """Build the native host library and, on a card, the kernel library
    once, before the ranks start."""
    from darwin_tpu_torch import native

    native.available()
    if device.type == "cuda":
        from darwin_tpu_torch import _build

        _build.lib()


def run(args, device) -> dict:
    """The three runs and the model's numbers: {one, many, amort (the
    run_cli dicts), parity (bool), dup_s, dup_amortized_s,
    peer_table_s, efficiency, model, model_amortized}."""
    from darwin_tpu_torch.eval.datagen import sample_reads, synth_genome
    from darwin_tpu_torch.io.fasta import write_fasta

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    genome = synth_genome(args.genome, rng)
    fasta = work / "reads.fasta"
    write_fasta(fasta, sample_reads(genome, args.reads, args.read_len, rng,
                                    error_rate=0.1, rc_fraction=0.5))
    print(f"dataset: {args.reads} x {args.read_len} bp over {args.genome} "
          f"bp genome; {os.cpu_count()} host cores; every rank on "
          f"--device {args.device}", flush=True)
    if device.type == "cuda":
        print("note: the ranks share one device and its host: this "
              "measures the mechanism (duplicated work, merge), not "
              "scaling", flush=True)
    build_libraries(device)
    one = run_cli(args, fasta, "p1", 1)
    many = run_cli(args, fasta, f"p{args.procs}", args.procs)
    table = work / "table.npz"
    table.unlink(missing_ok=True)
    amort = run_cli(args, fasta, f"p{args.procs}a", args.procs,
                    ["--seed-table", str(table)])
    parity = (one["merged"] == sorted(set(one["merged"]))
              and one["merged"] == many["merged"] == amort["merged"])

    def dup_of(r):
        return float(np.mean([m["ref_load_ms"] + m["read_load_ms"]
                              + m["seed_table_ms"] for m in r["metrics"]]))

    m1 = one["metrics"][0]
    align1 = m1["seed_ms"] + m1["gact_ms"]
    dup, dup_a = dup_of(many), dup_of(amort)
    n = args.procs
    return dict(
        one=one, many=many, amort=amort, parity=parity, align1_ms=align1,
        alignN_ms=max(m["seed_ms"] + m["gact_ms"] for m in many["metrics"]),
        dup_ms=dup, dup_amortized_ms=dup_a,
        peer_table_ms=(float(np.mean([m["seed_table_ms"]
                                      for m in amort["metrics"][1:]]))
                       if n > 1 else 0.0),
        efficiency=(args.reads / many["wall"]) / (args.reads / one["wall"]
                                                  * n),
        model=align1 / (align1 / n + dup) / n,
        model_amortized=align1 / (align1 / n + dup_a) / n)


def report(args, r: dict) -> None:
    one, many, n = r["one"], r["many"], args.procs
    m1 = one["metrics"][0]
    print(f"1 proc : wall {one['wall']:.3f} s = {args.reads / one['wall']:.2f}"
          f" reads/s (align {r['align1_ms'] / 1e3:.3f} s)")
    print(f"{n} procs: wall {many['wall']:.3f} s = "
          f"{args.reads / many['wall']:.2f} reads/s (slowest align "
          f"{r['alignN_ms'] / 1e3:.3f} s, duplicated global work "
          f"{r['dup_ms'] / 1e3:.3f} s/proc)")
    print(f"{n} procs + --seed-table: duplicated global work "
          f"{r['dup_amortized_ms'] / 1e3:.3f} s/proc (peer table wait+load "
          f"{r['peer_table_ms'] / 1e3:.3f} s vs build "
          f"{m1['seed_table_ms'] / 1e3:.3f} s)")
    print(f"wall-clock efficiency: {r['efficiency']:.2f} ({n} ranks on "
          f"--device {args.device}, {os.cpu_count()} host cores)")
    print(f"projected efficiency with {n} real devices/hosts: "
          f"{r['model']:.2f} rebuild / {r['model_amortized']:.2f} amortized "
          f"(align/N + duplicated-global-work model)", flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"torch_scaling_run: {e}", file=sys.stderr)
        return 2
    r = run(args, dev)
    if not r["parity"]:
        print("PARITY: FAILED between the 1-process and the "
              f"{args.procs}-process merges")
        return 1
    print(f"PARITY: EXACT ({len(r['one']['merged'])} records, incl. "
          f"--seed-table amortized run)")
    report(args, r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
