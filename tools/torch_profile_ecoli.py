"""Where the time goes in the PyTorch port's E.coli-shaped slice.

    python tools/torch_profile_ecoli.py [OUT_FILE]     (needs a CUDA card)

Builds the E.coli-shaped dataset (tools/ecoli_shape.py's recipe),
times the port's pipeline stages with host timers (genome, banks and
seed table once; D-SOFT and the engine over REPS warm runs), then runs
the engine again under torch.profiler and reports its device busy and
idle share, the device time by kernel, and the kernel launches per
engine iteration.
The full per-kernel table goes to OUT_FILE, or to standard output
when no OUT_FILE is given.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import darwin_tpu  # noqa: F401,E402  (THP madvise guard)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from darwin_tpu.config import Params  # noqa: E402
from darwin_tpu.eval.datagen import sample_reads, synth_genome  # noqa: E402
from darwin_tpu.index.genome import Genome  # noqa: E402
from darwin_tpu.index.seed_table import SeedTable  # noqa: E402
from darwin_tpu.io.fasta import FastaRecord  # noqa: E402
from darwin_tpu_torch.pipeline import (make_merged_engine,  # noqa: E402
                                       read_banks, run_device_merged)

REPS = 5


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out_file = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    params = Params()
    rng = np.random.default_rng(42)
    g = synth_genome(4_600_000, rng)
    reads = [FastaRecord([n], s) for n, s in
             sample_reads(g, 460, 10_000, rng, error_rate=0.12,
                          rc_fraction=0.5)]

    t = {}
    t0 = time.perf_counter()
    genome = Genome(reads, params.bin_size)
    fwd, rev = read_banks(reads)
    t["genome_and_banks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prebuilt = make_merged_engine(genome, fwd, rev, params, same_file=True,
                                  batch_size=512, device=dev)
    torch.cuda.synchronize()
    t["engine_build_upload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    t["seed_table_s"] = time.perf_counter() - t0

    def engine_run():
        m = {}
        recs, _ = run_device_merged(genome, table, fwd, rev, params,
                                    same_file=True, batch_size=512,
                                    prebuilt=prebuilt, metrics=m)
        torch.cuda.synchronize()
        return recs, m

    engine_run()  # the first run builds the kernels
    runs = [engine_run() for _ in range(REPS)]
    recs, m = runs[-1]
    for key in ("seed_s", "align_s"):
        vals = [r[1][key] for r in runs]
        t[key] = statistics.median(vals)
        t[key + "_runs"] = vals
    t.update(iters=m["engine_iters"],
             mean_active=m["engine_active_sum"] / m["engine_iters"],
             records=len(recs))
    print(f"host timers (D-SOFT and engine: median of {REPS} warm runs):",
          t, flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, m = engine_run()
        wall_us = (time.perf_counter() - t0) * 1e6
    engine_us = m["align_s"] * 1e6
    busy = defaultdict(float)
    count = defaultdict(int)
    launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchKernelExC"):
            launches += 1
    total = sum(busy.values())
    iters = m["engine_iters"]
    print(f"profiled run: wall {wall_us / 1e6:.3f} s (seed "
          f"{m['seed_s']:.3f} s, engine {m['align_s']:.3f} s); device "
          f"busy {total / 1e6:.4f} s = {100 * total / engine_us:.1f}% of "
          f"the engine loop, idle {100 - 100 * total / engine_us:.1f}%; "
          f"{launches} kernel launches = {launches / iters:.0f} per "
          f"iteration over {iters} iterations", flush=True)
    rows = sorted(busy.items(), key=lambda kv: -kv[1])
    lines = [f"{v / 1e3:10.3f} ms {100 * v / total:5.1f}% "
             f"{count[k]:7d}x  {k[:110]}" for k, v in rows]
    print("device time by kernel (top 12):")
    print("\n".join(lines[:12]), flush=True)
    full = ("\n".join(lines) + "\n\n"
            + prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=40) + "\n")
    if out_file is None:
        print(full)
    else:
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text(f"device: {smi}\nhost timers: {t}\n\n" + full)
        print(f"full table: {out_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
