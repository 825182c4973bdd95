"""Geometry sweep of the tile DP kernel against its plain version.

The port of tools/geom_sweep.py: runs csrc/dp.cu (ops/dp.py::
align_tiles) across a matrix of (B, T, dir_format, interleave), where
interleave is the number of tiles a warp steps together, and checks
every output bit-exact against the plain version
(ops/dp.py::align_tiles_plain) on the same device.  The tool's
block_b has no counterpart here (a warp holds whole tiles), so its
matrix loses that column and one duplicate row, and gains interleave 4.
--warps runs each config at each number of warps a thread block (the
one-warp path's occupancy knob) and prints the time of each.  A T past
that path's limit (ops/dp.py ONE_WARP_TILE) runs the split path, one
tile over several warps.  All configs run in one process: the tool's
child-per-config isolation exists only for Mosaic aborts.

Usage:
  python -m darwin_tpu_torch.lab.geom_sweep [--device cuda|cpu]
      [--config B,T,FMT,IL ...] [--warps 1,2,4,8]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from darwin_tpu_torch.lab import (SCORING, add_device_arg, clock,
                                  resolve_device, time_ms)
from darwin_tpu_torch.ops.dp import (PACKERS, WARPS, align_tiles,
                                     align_tiles_plain, run_kernel)

# (B, T, dir_format, interleave): the production geometry first, then
# the tile variants the engine's buckets can select, the small-B
# straggler batch, the other two formats, and the interleaved kernel.
DEFAULT_MATRIX = [
    (512, 320, "packed6", 1),
    (256, 320, "packed6", 1),
    (512, 128, "packed6", 1),
    (256, 512, "packed6", 1),
    (32, 320, "packed6", 1),
    (256, 320, "packed", 1),
    (256, 320, "bytes", 1),
    (512, 320, "packed6", 2),
    (512, 320, "packed6", 4),
]


def sweep_inputs(B: int, T: int):
    """The tool's inputs for one config: related ACGT tiles (12%
    substitutions), lengths in T/2..T."""
    rng = np.random.default_rng(B * 31 + T)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = alpha[rng.integers(0, 4, size=(B, T))]
    query = ref.copy()
    mut = rng.random((B, T)) < 0.12
    query[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
    rlen = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    qlen = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    return ref, query, rlen, qlen


def max_abs_err(got: dict, want: dict) -> int:
    """Largest |got - want| over all outputs; raises if the keys, shapes
    or dtypes differ."""
    if got.keys() != want.keys():
        raise AssertionError(f"outputs {sorted(got)} vs {sorted(want)}")
    err = 0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{k}: {tuple(g.shape)} {g.dtype} vs "
                                 f"{tuple(w.shape)} {w.dtype}")
        # By pieces of 2^26 elements: the split path's outputs at B = 512,
        # T = 2048 hold 2^31 words.
        for gp, wp in zip(g.reshape(-1).split(1 << 26),
                          w.reshape(-1).split(1 << 26)):
            if gp.numel():
                err = max(err, int((gp.long() - wp.long()).abs().max()))
    return err


def run_one(B: int, T: int, fmt: str, il: int, device: torch.device,
            reps: int = 5, warps=(WARPS,)) -> dict:
    """One config: kernel vs plain.  Returns dict(max_abs_err, ms,
    plain_ms, ms_by_warps); ms is the kernel's mean over reps calls
    through align_tiles, ms_by_warps the same at each number of warps a
    block on a CUDA device, plain_ms one call of the plain version."""
    ref, query, rlen, qlen = (torch.from_numpy(x).to(device)
                              for x in sweep_inputs(B, T))
    plain_ms, want = time_ms(
        lambda: align_tiles_plain(ref, query, rlen, qlen, dir_format=fmt,
                                  **SCORING),
        device, reps=1)
    ms, got = time_ms(
        lambda: align_tiles(ref, query, rlen, qlen, dir_format=fmt,
                            interleave=il, **SCORING), device, reps=reps)
    err = max_abs_err(got, want)
    by_warps = {}
    if device.type == "cuda":
        for w in warps:
            by_warps[w], out = time_ms(
                lambda w=w: run_kernel(ref, query, rlen, qlen, fmt=fmt,
                                       interleave=il, what="geom_sweep",
                                       warps=w, **SCORING)[0], device, reps)
            if fmt != "bytes":
                out["dir_words"] = out.pop("dir")
            err = max(err, max_abs_err(out, want))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                ms_by_warps=by_warps)


def sweep(matrix, device: torch.device, warps=(WARPS,)) -> list:
    """Run every config; returns [(B, T, fmt, il, result dict)]."""
    rows = []
    for B, T, fmt, il in matrix:
        r = run_one(B, T, fmt, il, device, warps=warps)
        status = "OK" if r["max_abs_err"] == 0 else "MISMATCH"
        by = "".join(f", {w} warps {ms:.4f}"
                     for w, ms in r["ms_by_warps"].items())
        print(f"{status} B={B} T={T} fmt={fmt} il={il}: max_abs_err "
              f"{r['max_abs_err']}, kernel {r['ms']:.4f} ms{by}, plain "
              f"{r['plain_ms']:.2f} ms ({clock(device)})", flush=True)
        rows.append((B, T, fmt, il, r))
    return rows


def _config(s: str):
    B, T, fmt, il = s.split(",")
    if fmt not in PACKERS:
        raise argparse.ArgumentTypeError(f"format {fmt!r}")
    return int(B), int(T), fmt, int(il)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="darwin_tpu_torch.lab.geom_sweep",
                                description=__doc__.splitlines()[0])
    add_device_arg(p)
    p.add_argument("--config", type=_config, action="append",
                   help="B,T,FMT,IL (repeatable; default: the matrix)")
    p.add_argument("--warps", default=str(WARPS),
                   type=lambda v: tuple(int(w) for w in v.split(",")),
                   help="warps a thread block to time each config at, "
                        f"comma-separated (default {WARPS})")
    args = p.parse_args(argv)
    rows = sweep(args.config or DEFAULT_MATRIX, resolve_device(args.device),
                 args.warps)
    bad = [r[:4] for r in rows if r[4]["max_abs_err"]]
    print(f"[sweep] {len(rows) - len(bad)}/{len(rows)} configs exact; "
          f"failures: {bad if bad else 'none'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
