"""Kernel experiment harness: time the DP and traceback kernels.

The port of tools/kernel_lab.py (and of tools/ilp_probe.py, whose one
variant a process is the `ilp` experiment here).  Each experiment runs
V chained steps of one component at the bench shape (B = 2048, T =
320; ET = 200) on V related tile batches made from seed 0 as the tool
makes them, times them with CUDA events, and prints ms/step and the
sink the tool computes (int32 wraparound).

Experiments: dp (byte DP), tb (the port's byte walker, csrc/
traceback.cu, on the V DP outputs), base (dp and tb), byte_full (DP +
walker a step), packed (packed DP + its walker, csrc/
traceback_words.cu, a step), packed_dp (packed DP only), packed6
(packed6 DP + walker a step, then the DP alone), p6compact (the packed6
step at compact_b 0, 64, 128, 256, 512), tbunroll (the packed step at
unroll 1, 2, 4, 8), ilp (interleave 1, 2, 4 in --format, default
packed: 1, 2 or 4 tiles stepping together in a warp; tools/
ilp_probe.py), tbiters (how far the walk runs).  The
walker kernels run each tile on its own thread, so compact_b and unroll
do not change them; the experiments time the tool's sweep all the same,
and on the CPU the plain walkers take both.

Usage:
  python -m darwin_tpu_torch.lab.kernel_lab [exp ...] [--device cuda|cpu]
      [--batch 2048] [--tile 320] [--et 200] [--variants 16]
"""

from __future__ import annotations

import argparse
import sys

import torch

from darwin_tpu_torch.lab import (SCORING, add_device_arg, clock,
                                  related_batches, resolve_device, sum32,
                                  time_ms)
from darwin_tpu_torch.ops.dp import INTERLEAVES, PACKERS, align_tiles
from darwin_tpu_torch.ops.traceback import WALKERS

EXPERIMENTS = ("base", "dp", "tb", "byte_full", "packed", "packed_dp",
               "packed6", "p6compact", "tbunroll", "ilp", "tbiters")


class Lab:
    """The inputs of one run and the experiments over them."""

    def __init__(self, device: torch.device, B: int, T: int, ET: int,
                 V: int):
        self.dev, self.B, self.T, self.ET, self.V = device, B, T, ET, V
        refs, queries = related_batches(V, B, T)
        self.refs = torch.from_numpy(refs).to(device)
        self.queries = torch.from_numpy(queries).to(device)
        self.rlen = torch.full((B,), T, dtype=torch.int32, device=device)
        self.qlen = self.rlen
        firsts = torch.zeros(B, dtype=torch.bool)
        firsts[: B // 2] = True
        self.firsts = firsts.to(device)

    def dp(self, v: int, **kw) -> dict:
        return align_tiles(self.refs[v], self.queries[v], self.rlen,
                           self.qlen, **SCORING, **kw)

    def walk(self, out: dict, fmt: str = "bytes", **kw):
        key, walker = WALKERS[fmt]
        return walker(out[key], self.rlen, self.qlen, self.firsts,
                      out["max_i"], out["max_j"], early_terminate=self.ET,
                      **kw)

    def chain(self, step):
        """sum over v of step(v), on the device (int64; wrapped on
        read)."""
        def fn():
            acc = torch.zeros((), dtype=torch.int64, device=self.dev)
            for v in range(self.V):
                acc = acc + step(v)
            return acc
        return fn

    def report(self, name: str, fn, gcups: bool = True) -> None:
        ms, sink = time_ms(fn, self.dev)
        cells = self.B * self.T * self.T * self.V
        rate = f" ({cells / ms / 1e6:.2f} GCUPS)" if gcups else ""
        print(f"{name}: {ms / self.V:.4f} ms/step{rate} sink "
              f"{sum32(sink)} ({clock(self.dev)})", flush=True)

    @staticmethod
    def dir_sink(out: dict) -> torch.Tensor:
        d = out["dir_words"] if "dir_words" in out else out["dir"]
        return (d.to(torch.int64)[:, ::64, ::64].sum()
                + out["max_score"].sum(dtype=torch.int64))

    def walk_sink(self, out: dict, fmt: str = "bytes", **kw) -> torch.Tensor:
        raw, i_s, j_s = self.walk(out, fmt, **kw)
        return ((raw & 3).sum(dtype=torch.int64) + i_s.sum(dtype=torch.int64)
                + j_s.sum(dtype=torch.int64))

    def full_step(self, fmt: str, **kw):
        """DP in fmt and its walker a step (sink as the tool's)."""
        def step(v):
            out = self.dp(v, dir_format=fmt)
            return (self.walk_sink(out, fmt, **kw)
                    + out["max_score"].sum(dtype=torch.int64))
        return self.chain(step)

    def run(self, exp: str, fmt: str) -> None:
        if exp in ("base", "dp"):
            self.report("dp_only", self.chain(
                lambda v: self.dir_sink(self.dp(v))))
        if exp in ("base", "tb"):
            outs = [self.dp(v) for v in range(self.V)]
            self.report("tb_only", self.chain(
                lambda v: self.walk_sink(outs[v])), gcups=False)
        if exp == "byte_full":
            self.report("byte full step", self.full_step("bytes"))
        if exp in ("packed", "packed6"):
            self.report(f"{exp} full step", self.full_step(exp))
        if exp in ("packed_dp", "packed6"):
            f = "packed" if exp == "packed_dp" else "packed6"
            self.report(f"{f} dp_only", self.chain(
                lambda v: self.dir_sink(self.dp(v, dir_format=f))),
                gcups=False)
        if exp == "p6compact":
            for kb in (0, 64, 128, 256, 512):
                self.report(f"packed6 compact_b={kb}",
                            self.full_step("packed6", compact_b=kb))
        if exp == "tbunroll":
            for u in (1, 2, 4, 8):
                self.report(f"packed step tb-unroll={u}",
                            self.full_step("packed", unroll=u))
        if exp == "ilp":
            for il in INTERLEAVES:
                self.report(f"{fmt} dp interleave={il}", self.chain(
                    lambda v, il=il: self.dir_sink(
                        self.dp(v, dir_format=fmt, interleave=il))))
        if exp == "tbiters":
            raw = self.walk(self.dp(0))[0]
            nz = raw != 0
            print(f"tb iterations used: {int(nz.any(dim=0).sum())} / "
                  f"{raw.shape[1]}  (mean steps/tile "
                  f"{float(nz.sum(dim=1).float().mean()):.1f})", flush=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="darwin_tpu_torch.lab.kernel_lab",
                                description=__doc__.splitlines()[0])
    p.add_argument("exps", nargs="*", default=["base"],
                   help=f"experiments: {', '.join(EXPERIMENTS)}")
    add_device_arg(p)
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--tile", type=int, default=320)
    p.add_argument("--et", type=int, default=200)
    p.add_argument("--variants", type=int, default=16)
    p.add_argument("--format", default="packed", choices=tuple(PACKERS),
                   help="dir format of the ilp experiment")
    args = p.parse_args(argv)
    for exp in args.exps:
        if exp not in EXPERIMENTS:
            print(f"kernel_lab: unknown experiment {exp!r}", file=sys.stderr)
            return 2
    lab = Lab(resolve_device(args.device), args.batch, args.tile, args.et,
              args.variants)
    for exp in args.exps:
        lab.run(exp, args.format)
    return 0


if __name__ == "__main__":
    sys.exit(main())
