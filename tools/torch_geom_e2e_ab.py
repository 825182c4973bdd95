"""Same-process end-to-end A/B of GACT tile sizes on one device.

    python3 tools/torch_geom_e2e_ab.py [--tiles 376,504,248] [--reps 3]
        [--genome 4600000] [--reads 460] [--read-len 10000] [--seed 42]
        [--guided] [--batch-size 2048] [--params configs/tpu.cfg]
        [--device cuda|cpu]

The counterpart of tools/geom_e2e_ab.py.  It runs the whole warm
pipeline (darwin_tpu_torch.pipeline.run_pipeline on the device engine:
genome, banks, engine build, seed table, D-SOFT, GACT, records) once a
tile size in one process, the sizes in turns, so that drift on the
machine falls on all of them alike: first one cold pass a size, then
--reps timed passes round-robin.  Every pass's record set must equal
that size's first (it exits 1 otherwise).  It prints the best and the
median wall, reads/s (best), the engine's iterations and the record
count a size, and whether the size's record set equals the first
size's.

The dataset is geom_e2e_ab.py's, E.coli-shaped by default: seed 42, a
4.6 Mb synthetic genome, 460 reads of 10 kb at 12% error, half reverse
complemented, self-overlap (--guided: reads against the genome), each
read named by datagen's R<id>_<pos>_<len> (FastaRecord([name], seq)).
The params are --params' (configs/tpu.cfg, read and never written) with
tile_size set to each size; early_terminate follows as tile_size -
tile_overlap.  With --device cpu the kernels' plain versions run and
the walls are host times on the CPU.  Without a card and without
--device cpu it exits 2.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import darwin_tpu_torch  # noqa: F401,E402  (THP madvise guard)
import numpy as np  # noqa: E402

from darwin_tpu_torch.lab import add_device_arg, resolve_device  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tiles", default="376,504,248")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--genome", type=int, default=4_600_000)
    p.add_argument("--reads", type=int, default=460)
    p.add_argument("--read-len", type=int, default=10_000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--guided", action="store_true")
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--params", default=str(REPO / "configs" / "tpu.cfg"))
    add_device_arg(p)
    return p.parse_args(argv)


def dataset(args) -> tuple:
    """(reference records, read records) of geom_e2e_ab.py's dataset."""
    from darwin_tpu_torch.eval.datagen import sample_reads, synth_genome
    from darwin_tpu_torch.io.fasta import FastaRecord

    rng = np.random.default_rng(args.seed)
    genome = synth_genome(args.genome, rng)
    reads = [FastaRecord([n], s) for n, s in
             sample_reads(genome, args.reads, args.read_len, rng,
                          error_rate=0.12, rc_fraction=0.5)]
    refs = [FastaRecord(["genome_0"], genome)] if args.guided else reads
    return refs, reads


def run_ab(args, device, refs, reads, log=print) -> dict:
    """{T: {cold_s, walls, best_s, median_s, reads_per_s, records (the
    sorted-unique record lines), iters (the engine's iterations in a
    pass)}} of the A/B; raises when a pass's record set differs from its
    size's first."""
    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.pipeline import run_pipeline

    tiles = [int(t) for t in args.tiles.split(",")]

    def one_pass(t):
        params = Params.from_cfg(args.params)
        params.tile_size = t
        m: dict = {}
        t0 = time.perf_counter()
        res = run_pipeline(refs, reads, params, same_file=not args.guided,
                           batch_size=args.batch_size, engine="device",
                           device=device, metrics=m)
        return (time.perf_counter() - t0, sorted(set(res.records)),
                m["engine_iters"])

    out = {}
    for t in tiles:
        wall, recs, iters = one_pass(t)
        out[t] = dict(cold_s=wall, walls=[], records=recs, iters=iters)
        log(f"T={t}: cold {wall:.3f} s, {len(recs)} unique records, "
            f"{iters} engine iterations")
    for rep in range(args.reps):
        for t in tiles:
            wall, recs, _ = one_pass(t)
            out[t]["walls"].append(wall)
            log(f"rep {rep} T={t}: {wall:.4f} s")
            if recs != out[t]["records"]:
                raise AssertionError(f"rep {rep} T={t}: the record set "
                                     f"differs from the cold pass's")
    for t, r in out.items():
        if r["walls"]:
            r["best_s"] = min(r["walls"])
            r["median_s"] = statistics.median(r["walls"])
            r["reads_per_s"] = len(reads) / r["best_s"]
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"torch_geom_e2e_ab: {e}", file=sys.stderr)
        return 2
    if dev.type == "cuda":
        from darwin_tpu_torch.bench import nvidia_smi_line

        print(f"device: nvidia-smi: {nvidia_smi_line()}", flush=True)
    refs, reads = dataset(args)
    try:
        res = run_ab(args, dev, refs, reads,
                     log=lambda s: print(s, flush=True))
    except AssertionError as e:
        print(f"torch_geom_e2e_ab: {e}", file=sys.stderr)
        return 1
    first = next(iter(res))
    if args.reps:
        print(f"\ngeometry  best_s  median_s  reads/s(best)  iterations  "
              f"records (= T={first}'s)")
        for t, r in res.items():
            print(f"T={t:<6} {r['best_s']:7.4f}  {r['median_s']:8.4f}  "
                  f"{r['reads_per_s']:8.1f}  {r['iters']:10d}  "
                  f"{len(r['records'])} "
                  f"({r['records'] == res[first]['records']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
