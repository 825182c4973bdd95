"""End-to-end CLI benchmark of the port: the mean wall time of N runs.

The counterpart of tools/bench_e2e.py (the reference's benchmark.py
methodology: run the CLI N times, average the wall time, surface
errors; benchmark.py:34-79), running ``python -m darwin_tpu_torch.cli``.
Each run writes into a directory of its own under a temporary
directory, removed at the end.  The first run builds the kernels and
the native library when the checkout has none yet, so the warm average
leaves it out.

Usage:
    python tools/torch_bench_e2e.py REF.fasta READS.fasta \\
        [--n 5] [--params params.cfg] [--batch-size 2048] \\
        [--device cuda] [-- extra CLI flags...]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("reference")
    p.add_argument("reads")
    p.add_argument("--n", type=int, default=5)
    p.add_argument("--params", default="params.cfg")
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--device", default="cuda")
    p.add_argument("extra", nargs="*", default=[],
                   help="extra CLI flags after --")
    args = p.parse_args(argv)

    times = []
    with tempfile.TemporaryDirectory() as td:
        for i in range(args.n):
            cmd = [sys.executable, "-m", "darwin_tpu_torch.cli",
                   str(Path(args.reference).resolve()),
                   str(Path(args.reads).resolve()), "--params", args.params,
                   "--batch-size", str(args.batch_size), "--device",
                   args.device, "--out-dir", str(Path(td) / f"run_{i}"),
                   *args.extra]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True,
                               cwd=REPO)
            dt = time.perf_counter() - t0
            if r.returncode != 0:
                print(f"run {i}: FAILED (exit {r.returncode})\n"
                      f"{r.stderr[-1500:]}")
                return 1
            times.append(dt)
            print(f"run {i}: {dt:.4f} s", flush=True)
    avg_all = sum(times) / len(times)
    warm = times[1:] or times
    print(f"average ({args.n} runs): {avg_all:.4f} s; "
          f"warm average: {sum(warm) / len(warm):.4f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
