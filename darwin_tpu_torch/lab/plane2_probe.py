"""Second-word-plane probe: what the plane costs to emit and to gather.

The port of tools/plane2_probe.py.  Two measurements:

  emit   : the packed6 DP kernel (ops/dp.py) against the plane-2
           kernel (ops/plane2.py), which also writes the second int32
           plane of deeper diagonal cells; V chained steps at B = 2048,
           rlen = qlen = T, at any T up to 2048 (past 1023 the split
           kernels: each line names the kernel ops/dp.py's plan picks).
           Sink: the tool's (the [::64, ::64] samples of both planes plus
           the max scores, int32 wraparound).
  gather : the walker's dependent gather widened three ways: one plane
           [B, 1], both planes interleaved [B, 2], two separate [B, 1]
           gathers, each a chain of 45 steps (the packed6 walker's
           rounds at the bench shape), V walks; each printed beside its
           bound, the bytes a walk gathers over the HBM rate.  The gathers are plain
           PyTorch, as the tool's are plain XLA; on the card each mode's
           V walks are captured in one CUDA graph, so the time is the
           gathers', not the host's launches; the eager time is printed
           beside it.

Usage:
  python -m darwin_tpu_torch.lab.plane2_probe {emit|gather} [T]
      [--device cuda|cpu] [--batch 2048] [--variants 8]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from darwin_tpu_torch.lab import (SCORING, add_device_arg, clock,
                                  related_batches, resolve_device, sum32,
                                  time_ms)
from darwin_tpu_torch.ops.dp import align_tiles, plan
from darwin_tpu_torch.ops.plane2 import plane2

ITERS = 45  # packed6 walker rounds at the bench shape (the tool's)
GATHER_MODES = ("one", "wide2", "twosep")
HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM's HBM rate


def gather_bound_ms(B: int, mode: str) -> float:
    """A walk's bound: the int32 values its ITERS gathers read (one a
    lane, two for wide2 and twosep) over the HBM rate."""
    return ITERS * B * 4 * (1 if mode == "one" else 2) / HBM_BYTES_S * 1e3


def base_sink(out: dict) -> torch.Tensor:
    """The tool's base_fn sink (int64 on the device)."""
    return (out["dir_words"][:, ::64, ::64].sum(dtype=torch.int64)
            + out["max_score"].sum(dtype=torch.int64))


def plane2_sink(out: dict) -> torch.Tensor:
    """The tool's plane2 sink.  The words here are T+1 columns wide, not
    the TPU's 128-lane padding; the [::64] samples agree while T+1 and
    T+2, the padding columns with bytes in them, are not multiples of
    64, as at the tool's T = 376 and at T = 24."""
    return (base_sink(out)
            + out["dir2_words"][:, ::64, ::64].sum(dtype=torch.int64))


def probe_emit(T: int, device: torch.device, B: int, V: int,
               reps: int = 3) -> dict:
    """Time packed6 alone and packed6 + plane 2; returns {name: (ms per
    step, sink)}."""
    refs, queries = (torch.from_numpy(x).to(device)
                     for x in related_batches(V, B, T))
    lens = torch.full((B,), T, dtype=torch.int32, device=device)
    steps = {
        "packed6 base": lambda v: base_sink(align_tiles(
            refs[v], queries[v], lens, lens, dir_format="packed6",
            **SCORING)),
        "packed6+plane2": lambda v: plane2_sink(plane2(
            refs[v], queries[v], lens, lens, **SCORING)),
    }
    res = {}
    for (name, step), fmt in zip(steps.items(), ("packed6", "plane2")):
        kernel = ("plain" if device.type == "cpu"
                  else plan(T, fmt, 1, **SCORING).kernel)
        def chain(step=step):
            acc = torch.zeros((), dtype=torch.int64, device=device)
            for v in range(V):
                acc = acc + step(v)
            return acc
        ms, sink = time_ms(chain, device, reps)
        res[name] = (ms / V, sum32(sink))
        print(f"emit {name}: T={T} {ms / V:.4f} ms/step "
              f"({B * T * T * V / ms / 1e6:.2f} GCUPS, {kernel}) sink "
              f"{res[name][1]} ({clock(device)})", flush=True)
    return res


def gather_inputs(B: int, T: int):
    """The tool's two gather tables: [B, T*C] and [B, T*C, 2] random
    int32, C = T+1 rounded up to 128 (seed 0)."""
    rng = np.random.default_rng(0)
    C = -(-(T + 1) // 128) * 128
    flat1 = rng.integers(0, 1 << 30, size=(B, T * C), dtype=np.int32)
    flat2 = rng.integers(0, 1 << 30, size=(B, T * C, 2), dtype=np.int32)
    return flat1, flat2


def walks(mode: str, f1: torch.Tensor, f2: torch.Tensor, V: int):
    """V chained walks of ITERS dependent gathers; returns the int64 sum
    of every walk's last values (the tool's scan accumulator)."""
    B, n = f1.shape
    d2f = f2.reshape(B, 2 * n)
    acc = torch.zeros((), dtype=torch.int64, device=f1.device)
    lane = torch.arange(B, dtype=torch.int64, device=f1.device)
    for seed in range(V):
        idx = (lane + seed * 131) % n
        val = torch.zeros(B, dtype=torch.int32, device=f1.device)
        for _ in range(ITERS):
            nidx = (idx + (val & 7) + 1) % (n - 2)
            if mode == "one":
                val = f1.gather(1, nidx[:, None])[:, 0]
            elif mode == "wide2":
                pair = d2f.gather(1, torch.stack([2 * nidx, 2 * nidx + 1],
                                                 dim=1))
                val = pair[:, 0] ^ pair[:, 1]
            else:  # two separate [B, 1] gathers
                val = (f1.gather(1, nidx[:, None])[:, 0]
                       ^ f1.gather(1, ((nidx + 7) % n)[:, None])[:, 0])
            idx = nidx
        acc = acc + val.sum(dtype=torch.int64)
    return acc


def probe_gather(T: int, device: torch.device, B: int, V: int,
                 reps: int = 3) -> dict:
    """Time each mode, in a CUDA graph on a card; returns {mode: (graph
    ms per walk or None on a CPU, eager ms per walk, sink)}."""
    f1, f2 = (torch.from_numpy(x).to(device) for x in gather_inputs(B, T))
    res = {}
    for mode in GATHER_MODES:
        eager_ms, sink = time_ms(lambda: walks(mode, f1, f2, V), device,
                                 reps)
        graph_ms = None
        if device.type == "cuda":
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # warm-up off the capture stream
                walks(mode, f1, f2, V)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph):
                static_sink = walks(mode, f1, f2, V)
            graph_ms, _ = time_ms(graph.replay, device, reps)
            if sum32(static_sink) != sum32(sink):
                raise AssertionError(f"gather {mode}: graph sink differs")
            del graph
        res[mode] = (None if graph_ms is None else graph_ms / V,
                     eager_ms / V, sum32(sink))
        timed = eager_ms if graph_ms is None else graph_ms
        print(f"gather {mode}: {timed / V:.4f} ms/walk "
              f"({timed / V / ITERS * 1e3:.1f} us/iter"
              f"{', CUDA graph' if graph_ms is not None else ''}; eager "
              f"{eager_ms / V:.4f} ms/walk; bound "
              f"{gather_bound_ms(B, mode):.6f} ms) sink {res[mode][2]} "
              f"({clock(device)})", flush=True)
    return res


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="darwin_tpu_torch.lab.plane2_probe",
                                description=__doc__.splitlines()[0])
    p.add_argument("which", nargs="?", default="gather",
                   choices=("emit", "gather"))
    p.add_argument("T", nargs="?", type=int, default=376)
    add_device_arg(p)
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--variants", type=int, default=8)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    probe = probe_emit if args.which == "emit" else probe_gather
    probe(args.T, dev, args.batch, args.variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
