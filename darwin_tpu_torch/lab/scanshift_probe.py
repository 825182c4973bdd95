"""Scan-lowering probe: the TPU DP's prefix-max scan, lowered two ways.

The port of tools/scanshift_probe.py.  The tool times the TPU DP
kernel's in-row shift-max scan in two lowerings (concat-shift and
roll+mask); here csrc/scanshift.cu times it in two GPU lowerings:

  shfl : one warp a row, its lanes' totals scanned by shuffles;
  smem : one warp a row, its lanes' totals scanned in shared memory
         under __syncwarp.

Each runs STEPS = 16 chained ``u = cummax(u + s)`` scans over every row
of V inputs [B, TJP] int32 (TJP = T+1 rounded up to 128), made from
seed 0 as the tool makes them, and prints the time and the tool's sink
(the int32 sum of the outputs, & 0xffff).  Then both lowerings are
checked against torch.cummax on the tool's cross-check input.

Usage:
  python -m darwin_tpu_torch.lab.scanshift_probe [T] [--device cuda|cpu]
      [--batch 2048] [--variants 8]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from darwin_tpu_torch.lab import (add_device_arg, clock, resolve_device,
                                  sum32, time_ms)
from darwin_tpu_torch.ops.scanshift import (STEPS, scanshift_shfl,
                                            scanshift_smem, scanshift_torch)

LOWERINGS = {"shfl": scanshift_shfl, "smem": scanshift_smem}
BB = 128  # rows of the tool's cross-check input (its block rows)


def probe_inputs(V: int, B: int, T: int):
    """The tool's timed input [V, B, TJP] and its cross-check input
    [BB, TJP], drawn in that order from seed 0."""
    TJP = -(-(T + 1) // 128) * 128
    rng = np.random.default_rng(0)
    x = rng.integers(-1000, 1000, size=(V, B, TJP), dtype=np.int32)
    u0 = rng.integers(-50, 50, size=(BB, TJP), dtype=np.int32)
    return x, u0


def run(T: int, device: torch.device, B: int, V: int,
        reps: int = 3) -> dict:
    """Returns {lowering: (ms for the V inputs, sink)}; raises if a
    lowering disagrees with torch.cummax."""
    x, u0 = (torch.from_numpy(a).to(device)
             for a in probe_inputs(V, B, T))
    TJP = x.shape[2]
    res = {}
    for name, fn in LOWERINGS.items():
        def chain(fn=fn):
            acc = torch.zeros((), dtype=torch.int64, device=device)
            for v in range(V):
                acc = acc + fn(x[v]).sum(dtype=torch.int64)
            return acc
        ms, sink = time_ms(chain, device, reps)
        res[name] = (ms, sum32(sink))
        print(f"{name}: {ms:.4f} ms total = {ms / (V * STEPS) * 1e3:.2f} us "
              f"per [{B},{TJP}] scan (sink {res[name][1] & 0xffff}) "
              f"({clock(device)})", flush=True)
    want = scanshift_torch(u0)
    for name, fn in LOWERINGS.items():
        if not torch.equal(fn(u0), want):
            raise AssertionError(f"{name} scan diverges from torch.cummax")
    print("scan variants agree with torch.cummax", flush=True)
    return res


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="darwin_tpu_torch.lab.scanshift_probe",
                                description=__doc__.splitlines()[0])
    p.add_argument("T", nargs="?", type=int, default=376)
    add_device_arg(p)
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--variants", type=int, default=8)
    args = p.parse_args(argv)
    run(args.T, resolve_device(args.device), args.batch, args.variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
