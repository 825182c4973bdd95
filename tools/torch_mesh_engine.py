#!/usr/bin/env python3
"""Time the port's ShardedGactEngine against its one-device engine on
the E.coli-shaped slice (chip_smoke's phase 4 dataset, its D-SOFT calls
from the native host D-SOFT), on one card.

    python3 tools/torch_mesh_engine.py [--entries 4] [--runs 3]

For each run, in turns: DeviceGactEngine on cuda:0; ShardedGactEngine
over --entries mesh entries of cuda:0, its entries run one after
another in the calling thread (as the CLI's --mesh runs them); and the
same engine with one host thread an entry, the reference's design
(one pthread a read range), which this tool puts in place of the
port's parallel/collectives.on_each.  Prints each run's align_s
(seconds from the calls to the records on the host), engine
iterations and records, the records checked equal to the dataset's
expected ones, and the card's name and power limit; the last line is
the same as one JSON object.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entries", type=int, default=4)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke
    from darwin_tpu_torch import _build
    from darwin_tpu_torch.engine import device_batch
    from darwin_tpu_torch.io.fasta import FastaRecord
    from darwin_tpu_torch.parallel.mesh import make_mesh
    from darwin_tpu_torch.pipeline import (format_records, make_merged_engine,
                                           read_banks, run_device_merged)

    if not torch.cuda.is_available():
        print("torch_mesh_engine: no CUDA device", file=sys.stderr)
        return 1
    _build.lib()  # the kernels' build is no part of a run's time
    dev = torch.device("cuda", 0)
    params, genome, table, _, _, _ = chip_smoke._ecoli_seed_inputs()
    reads = [FastaRecord([n], s) for n, s in chip_smoke.ecoli_reads()]
    fwd, rev = read_banks(reads)
    want = (chip_smoke.DATA / "ecoli_shape" / "jax_cpu.darwin"
            ).read_text().splitlines()
    mesh = make_mesh(devices=[dev] * args.entries)
    in_turn = device_batch.on_each

    def threaded(devices, fn):
        def run(i):
            with torch.cuda.device(devices[i]):
                return fn(i)

        with concurrent.futures.ThreadPoolExecutor(len(devices)) as pool:
            return list(pool.map(run, range(len(devices))))

    ways = {"one device": (None, in_turn),
            f"mesh of {args.entries}, in turn": (mesh, in_turn),
            f"mesh of {args.entries}, threads": (mesh, threaded)}
    out = {w: [] for w in ways}
    for _ in range(args.runs):
        for way, (m, runner) in ways.items():
            device_batch.on_each = runner
            eng = make_merged_engine(genome, fwd, rev, params, same_file=True,
                                     batch_size=512, device=dev, mesh=m)
            metrics = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs, _ = run_device_merged(genome, table, fwd, rev, params,
                                        same_file=True, batch_size=512,
                                        prebuilt=eng, metrics=metrics)
            wall = time.perf_counter() - t0
            lines = sorted(set(format_records(genome, reads, recs)))
            if lines != want:
                raise AssertionError(f"{way}: records differ")
            out[way].append(dict(align_s=metrics["align_s"], wall_s=wall,
                                 iters=metrics["engine_iters"],
                                 records=len(lines)))
            print(f"{way}: align_s {metrics['align_s']:.4f}, iterations "
                  f"{metrics['engine_iters']}, {len(lines)} records",
                  flush=True)
    device_batch.on_each = in_turn
    smi = chip_smoke.nvidia_smi_line()
    print(smi)
    print(json.dumps({"device": smi, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
