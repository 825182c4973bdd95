"""Tile-geometry probe: GCUPS of the full packed6 step at one T.

    python3 tools/torch_tile_geom.py T [ET] [--device cuda|cpu] [-B 2048]
        [-V 16]

The counterpart of tools/tile_geom.py, a thin command line over
darwin_tpu_torch.bench.measure at one geometry: bench.py's inputs (V
batches of B full T x T tiles from np.random.default_rng(0), 10% of the
query bases redrawn, half the tiles first tiles, scoring (1, -1, -1,
-1)), the packed6 DP (csrc/dp.cu) and the packed6 walker
(csrc/traceback_words.cu) chained over the V batches, timed with CUDA
events (median of 3 after a warm-up pass), and the DP alone the same
way.  GCUPS counts B*T*T cells a step, bench.py's definition.

Why T matters on the card: dp.cu runs one warp a tile, and lane l holds
a strip of C = ceil(T/32) columns in registers, so a tile's rows cost
32*C columns whatever T is inside the strip:

    T=248 -> C=8,  256 columns (96.9% useful)
    T=320 -> C=10, 320 columns (100%)    the reference's and the port's
    T=376 -> C=12, 384 columns (97.9%)   configs/tpu.cfg
    T=504 -> C=16, 512 columns (98.4%)

Past T = 1023 (the one-warp path's C = 32) a tile runs over S warps
of one block, each a strip of 32 C columns, pipelined (the split path:
ops/dp.py strips_for), at the default scoring two tiles a block in
16-bit halves: T = 1024 -> S = 2 at C = 16, 1536 -> S = 2 at C = 24,
2048 -> S = 4 at C = 16; T runs up to 2048, the reference's limit.  Give such sizes a
smaller -B: the packed6 words of B = 2048 tiles at T = 2048 take 34 GB.

(The TPU tool's argument, a lane axis of roundup(T+1, 128), does not
hold here.)  A larger T also means fewer engine iterations a call,
which this probe does not see: tools/torch_geom_e2e_ab.py measures that
end to end.

Prints the JAX tool's one line, with the step chain's sink (the sum of
bench.py's one_step sinks over the V batches, int32-wrapped as its scan
carry) beside it:

    T=... ET=... step_ms=... dp_ms=... gcups=... sink=...

With --device cpu the plain versions run (host wall times, not device
times); without a card and without --device cpu it exits 2.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from darwin_tpu_torch import bench  # noqa: E402
from darwin_tpu_torch.lab import add_device_arg, resolve_device  # noqa: E402


def probe(device, T: int, ET: int = 200, B: int = bench.B,
          V: int = bench.V) -> dict:
    """{T, ET, step_ms, dp_ms, gcups, sink} of one geometry."""
    gcups, step_ms, dp_ms, sink = bench.measure(device, B, T, ET, V,
                                                with_dp_split=True)
    return dict(T=T, ET=ET, step_ms=step_ms, dp_ms=dp_ms, gcups=gcups,
                sink=sink)


def line(r: dict) -> str:
    return (f"T={r['T']} ET={r['ET']} step_ms={r['step_ms']:.4f} "
            f"dp_ms={r['dp_ms']:.4f} gcups={r['gcups']:.4f} "
            f"sink={r['sink']}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("T", type=int)
    p.add_argument("ET", type=int, nargs="?", default=200)
    p.add_argument("-B", type=int, default=bench.B, help="tiles a batch")
    p.add_argument("-V", type=int, default=bench.V, help="distinct batches")
    add_device_arg(p)
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"torch_tile_geom: {e}", file=sys.stderr)
        return 2
    if dev.type == "cuda":
        print(f"device: nvidia-smi: {bench.nvidia_smi_line()}",
              file=sys.stderr)
    print(line(probe(dev, args.T, args.ET, args.B, args.V)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
