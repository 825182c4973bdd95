"""Headline benchmark: GACT tile-alignment GCUPS on one card.

    python3 -m darwin_tpu_torch.bench [--device cuda|cpu] [-B 2048]
        [-T 376/256 320/200] [-V 16]

The counterpart of the repo's bench.py.  It prints ONE JSON line on
stdout with bench.py's keys:

  {"metric": "gact_gcups", "value": <GCUPS>, "unit": "GCUPS",
   "vs_baseline": ..., "vs_cuda_modeled": ..., "tile_size": T,
   "step_ms": ..., "dp_ms": ..., "traceback_ms": ...,
   "gcups_ref_geom_t320": ...}

Measured quantity: the full tile step, the tile DP in dir_format
"packed6" (csrc/dp.cu) followed by the packed6 walker
(csrc/traceback_words.cu), on B = 2048 full T x T tiles: DP cells
updated per second.  The headline geometry is T = 376 / ET = 256 (with
the DP alone timed too, which splits step_ms into dp_ms and
traceback_ms), then the reference's own T = 320 / ET = 200
(gcups_ref_geom_t320).  The inputs are bench.py's: V = 16 distinct
batches from np.random.default_rng(0), queries with 10% of bases
redrawn, half the tiles first tiles, scoring (1, -1, -1, -1).  Each
step reduces every output into one int64 on the device (bench.py's
one_step sink; the DP-only step's is bench.py's dp_only_step sink), so
nothing is left unread.

Timing: all V batches are staged on the device first; the V steps are
launched back to back, their sinks added into one device accumulator,
and timed with CUDA events around the V steps: one warm-up pass, then
the median of 3 passes.  No CUDA graph: the host launches each step's
few kernels, as the engine does.  The card's name and power limit
(nvidia-smi) go to stderr with each geometry's times and sink, and at
the end the kernels' launch counts ("launches: {...}", JSON).

-T gives the two geometries as T/ET, the headline one first.  With
--device cpu the plain versions run at whatever size is given (the
tests use B = 8, -T 32/16 24/12, V = 2); its times are host wall times,
not device times.  Without a card and without --device cpu it exits 2.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from darwin_tpu_torch.lab import (SCORING, add_device_arg, related_batches,
                                  resolve_device, wrap32)
from darwin_tpu_torch.ops.dp import align_tiles, align_tiles_plain
from darwin_tpu_torch.ops.traceback import (traceback_packed6,
                                            traceback_packed6_torch)

# The yardsticks bench.py divides by; neither is a TPU figure.  The
# reference implementation's CPU kernel (AlignWithBT, align.cpp:60-233)
# measured single-threaded at 0.011 GCUPS (BENCH_NOTES.md), and a
# modelled K40 CUDA kernel (the op-census cost model of BASELINE.md,
# its realistic mid-point; the reference's CUDA build needs a Kepler
# GPU).
BASELINE_CPU_KERNEL_GCUPS = 0.011
MODELED_CUDA_KERNEL_GCUPS = 25.0

B = 2048
# (T, ET): the headline geometry (configs/tpu.cfg's) and the
# reference's own.
T, ET = 376, 256
GEOMETRIES = ((T, ET), (320, 200))
V = 16
PASSES = 3
I64 = torch.int64


class Batches:
    """bench.py's inputs for one geometry, staged on device."""

    def __init__(self, device: torch.device, B: int, T: int, V: int):
        refs, queries = related_batches(V, B, T)
        self.refs = torch.from_numpy(refs).to(device)
        self.queries = torch.from_numpy(queries).to(device)
        self.rlen = torch.full((B,), T, dtype=torch.int32, device=device)
        firsts = np.zeros(B, dtype=bool)
        firsts[: B // 2] = True
        self.firsts = torch.from_numpy(firsts).to(device)
        self.V = V


def _dp(b: Batches, v: int, plain: bool) -> dict:
    fn = align_tiles_plain if plain else align_tiles
    return fn(b.refs[v], b.queries[v], b.rlen, b.rlen,
              dir_format="packed6", **SCORING)


def one_step(b: Batches, v: int, et: int, plain: bool = False
             ) -> torch.Tensor:
    """bench.py's one_step sink of batch v: the sum of the walker's ops,
    i and j steps and the DP's max scores (int64 on the device).
    plain runs the plain versions of the DP and walker."""
    out = _dp(b, v, plain)
    walk = traceback_packed6_torch if plain else traceback_packed6
    raw, i_s, j_s = walk(out["dir_words"], b.rlen, b.rlen, b.firsts,
                         out["max_i"], out["max_j"], early_terminate=et)
    return ((raw & 3).sum(dtype=I64) + i_s.sum(dtype=I64)
            + j_s.sum(dtype=I64) + out["max_score"].sum(dtype=I64))


def dp_only_step(b: Batches, v: int) -> torch.Tensor:
    """bench.py's dp_only_step sink of batch v."""
    out = _dp(b, v, False)
    return (out["dir_words"][:, ::37, ::41].sum(dtype=I64)
            + out["max_score"].sum(dtype=I64)
            + out["max_i"].sum(dtype=I64))


def chained_ms(b: Batches, step, device: torch.device,
               passes: int = PASSES) -> tuple:
    """(ms of V chained steps, median of passes after a warm-up pass;
    the chain's sink, int32-wrapped as bench.py's scan carry)."""
    def chain():
        acc = torch.zeros((), dtype=I64, device=device)
        for v in range(b.V):
            acc = acc + step(v)
        return acc

    sink = wrap32(int(chain()))
    times = []
    for _ in range(passes):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            acc = chain()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            acc = chain()
            times.append((time.perf_counter() - t0) * 1e3)
        if wrap32(int(acc)) != sink:
            raise AssertionError("bench: a pass's sink differs from the "
                                 "warm-up's")
    return statistics.median(times), sink


def measure(device: torch.device, B: int, t: int, et: int, V: int,
            with_dp_split: bool) -> tuple:
    """(GCUPS, step ms, DP ms or None, the step chain's sink) of one
    geometry."""
    b = Batches(device, B, t, V)
    ms, sink = chained_ms(b, lambda v: one_step(b, v, et), device)
    dp_ms = None
    if with_dp_split:
        dp_ms = chained_ms(b, lambda v: dp_only_step(b, v), device)[0] / V
    gcups = V * B * t * t / ms / 1e6
    step_ms = ms / V
    split = ("" if dp_ms is None else
             f" = DP {dp_ms:.4f} + traceback {step_ms - dp_ms:.4f}")
    print(f"T={t} ET={et}: {V} chained steps {ms:.4f} ms ({step_ms:.4f} "
          f"ms/step{split}; sink {sink}) -> {gcups:.4f} GCUPS",
          file=sys.stderr)
    return gcups, step_ms, dp_ms, sink


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0]


def _geometry(text: str) -> tuple[int, int]:
    t, et = text.split("/")
    return int(t), int(et)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="darwin_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    add_device_arg(p)
    p.add_argument("-B", type=int, default=B, help="tiles a batch")
    p.add_argument("-T", nargs=2, type=_geometry, default=GEOMETRIES,
                   metavar="T/ET", help="the headline and the reference "
                   "geometry (default 376/256 320/200)")
    p.add_argument("-V", type=int, default=V, help="distinct batches")
    args = p.parse_args(argv)
    (t, et), (t_ref, et_ref) = args.T
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"darwin_tpu_torch.bench: {e}", file=sys.stderr)
        return 2
    where = (f"{torch.cuda.get_device_name(dev)}; nvidia-smi: "
             f"{nvidia_smi_line()}" if dev.type == "cuda"
             else "cpu (plain versions, host wall times)")
    print(f"device: {where}; B={args.B} T={t} ET={et} (ref geom T={t_ref} "
          f"ET={et_ref}) V={args.V}", file=sys.stderr)
    gcups, step_ms, dp_ms, _ = measure(dev, args.B, t, et, args.V,
                                       with_dp_split=True)
    gcups_ref = measure(dev, args.B, t_ref, et_ref, args.V,
                        with_dp_split=False)[0]
    print(json.dumps({
        "metric": "gact_gcups",
        "value": gcups,
        "unit": "GCUPS",
        "vs_baseline": gcups / BASELINE_CPU_KERNEL_GCUPS,
        "vs_cuda_modeled": gcups / MODELED_CUDA_KERNEL_GCUPS,
        "tile_size": t,
        "step_ms": step_ms,
        "dp_ms": dp_ms,
        "traceback_ms": step_ms - dp_ms,
        "gcups_ref_geom_t320": gcups_ref,
    }))
    # The kernels' launches in this run (counted on a card only); the DP's
    # split paths (T past the one-warp path's; int32 and 16-bit) count
    # apart.
    print("launches: " + json.dumps(
        {"align_tiles": align_tiles.launches,
         "align_tiles_split": align_tiles.split.launches,
         "align_tiles_split16": align_tiles.split16.launches,
         "traceback_packed6": traceback_packed6.launches}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
