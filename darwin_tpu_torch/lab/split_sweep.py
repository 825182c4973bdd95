"""Warps a tile and columns a lane of the split tile DP, on full tiles.

For each (B, T, format) it runs the int32 split kernel at ops/dp.py's
warps a tile (strips_for) as the reference, then the 16-bit split kernel
(two tiles a block in 16-bit halves) and the int32 one at each number
of warps a tile S in --strips, each at the least strip width C that
covers T (ops/dp.py check_strips), holds every output to the
reference's (tolerance 0) and times it with CUDA events (median of
--reps).  Full tiles (rlen = qlen = T, the lab's related_batches
inputs), so GCUPS = B T^2 / ms, as tools/torch_tile_geom.py counts
them.  A config whose direction output would pass --max-gb is skipped
(two outputs live at once: packed6 at B = 2048, T = 2048 takes 34 GB).

Usage:
  python -m darwin_tpu_torch.lab.split_sweep [--device cuda|cpu]
      [--tiles 1024,1536,2048] [--batches 512,2048]
      [--formats bytes,packed6] [--strips 2,3,4,6,8] [--reps 10]
On --device cpu each config runs the plain version once at the sizes
given (use small ones), and nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from darwin_tpu_torch.lab import (SCORING, add_device_arg, related_batches,
                                  resolve_device)
from darwin_tpu_torch.lab.geom_sweep import max_abs_err
from darwin_tpu_torch.ops.dp import (align_tiles_plain, check_strips,
                                     run_kernel, strips_for)


def _ints(v: str) -> tuple:
    return tuple(int(x) for x in v.split(","))


def median_ms(fn, reps: int) -> float:
    """Median of reps CUDA-event timings of fn(), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def inputs(B: int, T: int, device: torch.device):
    """B full [T] tiles of related ACGT (the lab's related_batches)."""
    refs, queries = related_batches(1, B, T)
    lens = torch.full((B,), T, dtype=torch.int32, device=device)
    return (torch.from_numpy(refs[0]).to(device),
            torch.from_numpy(queries[0]).to(device), lens, lens.clone())


def sweep_one(B: int, T: int, fmt: str, strips, device: torch.device,
              reps: int) -> list:
    """Rows (kernel, S, C, ms, gcups, max_abs_err) for one (B, T,
    format), the int32 kernel at strips_for's S first."""
    a = inputs(B, T, device)
    cells = B * T * T
    if device.type == "cpu":
        align_tiles_plain(*a, dir_format=fmt, **SCORING)
        return [("plain", 1, 0, None, None, 0)]

    def call(S, dp16):
        return lambda: run_kernel(*a, fmt=fmt, interleave=1, what="sweep",
                                  strips=S, dp16=dp16, **SCORING)

    S0 = strips_for(T, 1)
    want = call(S0, False)()
    rows = []
    for dp16 in (False, True):
        for S in strips:
            try:
                C = check_strips(T, 1, S, "sweep", dp16)
            except ValueError:
                continue
            got = call(S, dp16)()
            err = max_abs_err(got, want)
            del got
            ms = median_ms(call(S, dp16), reps)
            rows.append(("int16" if dp16 else "int32", S, C, ms,
                         cells / ms / 1e6, err))
    del want
    torch.cuda.empty_cache()
    return rows


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="darwin_tpu_torch.lab.split_sweep",
                                description=__doc__.splitlines()[0])
    add_device_arg(p)
    p.add_argument("--tiles", type=_ints, default=(1024, 1536, 2048))
    p.add_argument("--batches", type=_ints, default=(512, 2048))
    p.add_argument("--formats", default="bytes,packed6")
    p.add_argument("--strips", type=_ints, default=(2, 3, 4, 6, 8))
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--max-gb", type=float, default=20.0,
                   help="skip a config whose direction output passes this")
    p.add_argument("--json", help="also write the rows here")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    out, bad = [], 0
    for T in args.tiles:
        for B in args.batches:
            for fmt in args.formats.split(","):
                gb = B * T * (T + 1) * (1 if fmt == "bytes" else 4) / 1e9
                if gb > args.max_gb:
                    print(f"B={B} T={T} {fmt}: skipped ({gb:.1f} GB of "
                          f"output)", flush=True)
                    continue
                for kernel, S, C, ms, gcups, err in sweep_one(
                        B, T, fmt, args.strips, device, args.reps):
                    bad += err != 0
                    out.append(dict(B=B, T=T, fmt=fmt, kernel=kernel, S=S,
                                    C=C, ms=ms, gcups=gcups,
                                    max_abs_err=err))
                    timing = ("" if ms is None else
                              f" {ms:.4f} ms, {gcups:.1f} GCUPS,")
                    print(f"B={B} T={T} {fmt} {kernel} S={S} C={C}:"
                          f"{timing} max_abs_err {err}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(f"[split_sweep] {len(out) - bad}/{len(out)} runs exact", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
