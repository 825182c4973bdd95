"""Warps a tile and columns a lane of the split tile DP.

For each (B, T, format, interleave, lengths) it runs the int32 split
kernel at ops/dp.py's warps a tile (strips_for) as the reference, then
the int32 kernel and the 16-bit split kernel (a pair of tiles in 16-bit
halves) at each number of warps a tile S in --strips and each strip
width C that the kernel instantiates, whose strips cover T and whose
shared memory fits a block (ops/dp.py plan: SPLIT_WIDTHS,
split16_widths, split_smem), holds every output to the reference's
(tolerance 0) and times it with CUDA events (median of --reps), each
launch counted on its kernel's counter (ops/dp.py and ops/plane2.py
COUNTERS).  plane2 runs at interleave 1 only (ops/plane2.py), and which
combination the gate launches by default is marked.  The tiles are the
lab's related_batches inputs, "full" (rlen = qlen = T, so GCUPS = B T^2
/ ms, as tools/torch_tile_geom.py counts them) or "related" (rlen and
qlen drawn in 1..T, as chip_smoke's split timings take them; GCUPS
still counts B T^2).  A config whose direction output would pass --max-gb is
skipped (two outputs live at once: packed6 at B = 2048, T = 2048 takes
34 GB; plane 2 doubles it).

Usage:
  python -m darwin_tpu_torch.lab.split_sweep [--device cuda|cpu]
      [--tiles 1024,1536,2048] [--batches 512,2048]
      [--formats bytes,packed6] [--interleave 1] [--strips 1,2,3,4,6,8]
      [--lengths full,related] [--reps 10]
On --device cpu each config runs the plain version once at the sizes
given (use small ones), and nothing is timed.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np
import torch

from darwin_tpu_torch.lab import (SCORING, add_device_arg, related_batches,
                                  resolve_device)
from darwin_tpu_torch.lab.geom_sweep import max_abs_err
from darwin_tpu_torch.ops import dp
from darwin_tpu_torch.ops.plane2 import COUNTERS, plane2_torch


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


LENGTHS = ("full", "related")


def inputs(B: int, T: int, device: torch.device, lengths: str = "full"):
    """B [T] tiles of related ACGT (the lab's related_batches): full
    (rlen = qlen = T), or related (rlen and qlen uniform in 1..T, seed
    1)."""
    refs, queries = related_batches(1, B, T)
    if lengths == "full":
        rlen = qlen = np.full(B, T, dtype=np.int32)
    else:
        rng = np.random.default_rng(1)
        rlen, qlen = rng.integers(1, T + 1, size=(2, B)).astype(np.int32)
    return (torch.from_numpy(refs[0]).to(device),
            torch.from_numpy(queries[0]).to(device),
            torch.from_numpy(rlen).to(device),
            torch.from_numpy(qlen.copy()).to(device))


def variants(T: int, fmt: str, il: int, strips):
    """(kernel label, dp16, S, C) of every launch the sweep times: the
    int32 split kernel, then the 16-bit one, at each S of strips and each
    width instantiated that covers T over S warps within a block's shared
    memory (every launch that plan accepts)."""
    kinds = [("int32", False)]
    if dp.runs_int16(T, fmt, il, **SCORING):
        kinds.append(("int16", True))
    out = []
    for label, dp16 in kinds:
        widths = dp.split16_widths(fmt) if dp16 else dp.SPLIT_WIDTHS[il]
        for S in strips:
            if not dp16 and S == 1:
                continue
            for C in widths:
                try:
                    dp.plan(T, fmt, il, strips=S, dp16=dp16, width=C,
                            **SCORING)
                except ValueError:
                    continue
                out.append((label, dp16, S, C))
    return out


def count_launch(kernel: str, fmt: str, il: int) -> None:
    """Counts one of the sweep's launches on the counter of the kernel
    run_kernel reports, as align_tiles and plane2 count theirs."""
    if fmt == "plane2":
        COUNTERS[kernel].launches += 1
    else:
        dp.COUNTERS[kernel].launches += 1
        dp.COUNTERS[kernel].variant_launches[(fmt, il)] += 1


def sweep_one(B: int, T: int, fmt: str, il: int, strips,
              device: torch.device, reps: int, lengths: str = "full"):
    """Yields rows (kernel, S, C, ms, gcups, max_abs_err, default) for one
    (B, T, format, interleave, lengths), the int32 kernel first; default
    marks the launch the gate makes."""
    a = inputs(B, T, device, lengths)
    cells = B * T * T
    if device.type == "cpu":
        if fmt == "plane2":
            plane2_torch(*a, **SCORING)
        else:
            dp.align_tiles_plain(*a, dir_format=fmt, **SCORING)
        yield ("plain", 1, 0, None, None, 0, True)
        return

    def call(**kw):
        def run():
            out, kernel = dp.run_kernel(*a, fmt=fmt, interleave=il,
                                        what="sweep", **kw, **SCORING)
            count_launch(kernel, fmt, il)
            return out
        return run

    default = dp.plan(T, fmt, il, **SCORING)
    want = call(dp16=False, strips=dp.strips_for(T, il))()
    for label, dp16, S, C in variants(T, fmt, il, strips):
        kw = dict(dp16=dp16, strips=S, width=C)
        got = call(**kw)()
        err = max_abs_err(got, want)
        del got
        ms = median_ms(call(**kw), reps)
        is_default = (default.kernel == (dp.SPLIT16 if dp16 else dp.SPLIT)
                      and (default.strips, default.width) == (S, C))
        yield (label, S, C, ms, cells / ms / 1e6, err, is_default)
    del want
    torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="darwin_tpu_torch.lab.split_sweep",
                                description=__doc__.splitlines()[0])
    add_device_arg(p)
    p.add_argument("--tiles", type=_ints, default=(1024, 1536, 2048))
    p.add_argument("--batches", type=_ints, default=(512, 2048))
    p.add_argument("--formats", default="bytes,packed6")
    p.add_argument("--interleave", type=_ints, default=(1,))
    p.add_argument("--strips", type=_ints, default=(1, 2, 3, 4, 6, 8))
    p.add_argument("--lengths", default="full",
                   help=f"tile lengths, comma-separated from {LENGTHS}")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--max-gb", type=float, default=20.0,
                   help="skip a config whose direction output passes this")
    p.add_argument("--json", help="also write the rows here")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    lengths = args.lengths.split(",")
    if not set(lengths) <= set(LENGTHS):
        p.error(f"--lengths: {args.lengths!r}, not from {LENGTHS}")
    out, bad = [], 0
    for T, B, fmt, il in itertools.product(
            args.tiles, args.batches, args.formats.split(","),
            args.interleave):
        if (fmt == "plane2" and il != 1) or B % il:
            continue
        gb = (B * T * (T + 1) * (1 if fmt == "bytes" else 4)
              * (2 if fmt == "plane2" else 1) / 1e9)
        if gb > args.max_gb:
            print(f"B={B} T={T} {fmt} il={il}: skipped ({gb:.1f} GB of "
                  f"output)", flush=True)
            continue
        for ln in lengths:
            tag = "" if ln == "full" else f" {ln}"
            for kernel, S, C, ms, gcups, err, default in sweep_one(
                    B, T, fmt, il, args.strips, device, args.reps, ln):
                bad += err != 0
                out.append(dict(B=B, T=T, fmt=fmt, interleave=il, lengths=ln,
                                kernel=kernel, S=S, C=C, ms=ms, gcups=gcups,
                                max_abs_err=err, default=default))
                timing = ("" if ms is None else
                          f" {ms:.4f} ms, {gcups:.1f} GCUPS,")
                mark = " (default)" if default and ms else ""
                print(f"B={B} T={T} {fmt} il={il}{tag} {kernel} S={S} C={C}:"
                      f"{timing} max_abs_err {err}{mark}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(f"[split_sweep] {len(out) - bad}/{len(out)} runs exact", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
