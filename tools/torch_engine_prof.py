"""Engine iteration profiler: synthetic calls of known tile depth.

    python3 tools/torch_engine_prof.py [N] [--genome 2000000]
        [--read-len 4000] [--et 200] [--reps 3] [--profile]
        [--device cuda|cpu]

The counterpart of tools/engine_prof.py.  The calls are its own: a
synthetic genome from np.random.default_rng(0) (eval/datagen.synth_genome),
N reads of --read-len bases copied from it, one call a read anchored at
the read's middle, so each call walks about read_len / 2 / ET tiles each
way.  DeviceGactEngine (T = 320, early_terminate --et, threshold 35,
scoring (1, -1, -1, -1), batch_size = N, the bytes walker) runs them
with compute_score True and then False: one run to build, then --reps
warm runs (host clock, the engine's records downloaded).  For each it
prints the mean ms a run, the records, the engine's own iteration count
(last_iters; engine_prof.py estimates it), ms an iteration, and the
kernels' launches in a warm run (the DP, the byte walker and the span
fetch; counted on a card only, as the change of each wrapper's counter
over the warm runs: the counters are read, never reset).  With
--profile (a card only) one more run each goes under torch.profiler,
and the device's busy share of it and its launches an iteration are
printed (torch_profile.device_summary).

Without a card and without --device cpu it exits 2.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import darwin_tpu_torch  # noqa: F401,E402  (THP madvise guard)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from darwin_tpu_torch.lab import (SCORING, add_device_arg,  # noqa: E402
                                  launch_counters, resolve_device)

TILE = 320
THRESHOLD = 35
# The kernels of the engine's path (the bytes walker).
ENGINE_KERNELS = ("align_tiles", "traceback", "fetch_tiles")


def synthetic_calls(n: int, genome_len: int = 2_000_000,
                    read_len: int = 4000) -> dict:
    """engine_prof.py's workload as plain arrays: {genome (str), reads
    ([uint8 ASCII arrays]), ref_pos, query_pos (int64 [n])}."""
    from darwin_tpu_torch.eval.datagen import synth_genome

    rng = np.random.default_rng(0)
    genome = synth_genome(genome_len, rng)
    starts = rng.integers(0, genome_len - read_len, size=n)
    raw = np.frombuffer(genome.encode(), dtype=np.uint8)
    return dict(genome=genome,
                reads=[raw[s:s + read_len].copy() for s in starts],
                ref_pos=(starts + read_len // 2).astype(np.int64),
                query_pos=np.full(n, read_len // 2, dtype=np.int64))


def engine_inputs(w: dict) -> tuple:
    """(Genome, SeqBank, GactCalls) of synthetic_calls' arrays."""
    from darwin_tpu_torch.engine.batch import GactCalls
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.index.genome import Genome
    from darwin_tpu_torch.io.fasta import FastaRecord

    n = len(w["reads"])
    calls = GactCalls(ref_id=np.zeros(n, np.int64),
                      query_id=np.arange(n, dtype=np.int64),
                      ref_pos=w["ref_pos"], query_pos=w["query_pos"])
    return (Genome([FastaRecord(["ref"], w["genome"])], 64),
            SeqBank(w["reads"]), calls)


def profile_engine(device: torch.device, w: dict, et: int = 200,
                   reps: int = 3, profile: bool = False) -> dict:
    """{compute_score: {ms (a warm run, mean), iters, ms_per_iter,
    records, launches (a warm run's, {kernel: n}), summary
    (device_summary of a profiled run, or None)}} for True and False."""
    from darwin_tpu_torch.engine.device_batch import DeviceGactEngine

    genome, bank, calls = engine_inputs(w)
    counters = {k: launch_counters()[k] for k in ENGINE_KERNELS}
    out = {}
    for score in (True, False):
        eng = DeviceGactEngine(
            genome, bank, tile_size=TILE, early_terminate=et,
            first_tile_score_threshold=THRESHOLD, same_file=False,
            batch_size=len(calls), compute_score=score, device=device,
            **SCORING)
        eng.run(calls, False)  # builds the kernels
        before = {k: c.launches for k, c in counters.items()}
        t0 = time.perf_counter()
        for _ in range(reps):
            recs = eng.run(calls, False)
        dt = (time.perf_counter() - t0) / reps
        launches = {k: (c.launches - before[k]) // reps
                    for k, c in counters.items()}
        r = dict(ms=dt * 1e3, iters=eng.last_iters,
                 ms_per_iter=dt * 1e3 / max(1, eng.last_iters),
                 records=recs, launches=launches, summary=None)
        print(f"score={score} N={len(calls)}: {r['ms']:.2f} ms, "
              f"{r['iters']} iters -> {r['ms_per_iter']:.3f} ms/iter, "
              f"{len(recs)} records; launches a run {launches}",
              flush=True)
        if profile and device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile as prof_

            from torch_profile import device_summary

            with prof_(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.run(calls, False)
                wall = time.perf_counter() - t0
            s = r["summary"] = device_summary(prof, wall, eng.last_iters)
            top = [(k[:40], round(t * 1e3, 3), n)
                   for k, t, n in s["kernels"][:4]]
            print(f"  profiled run: {wall * 1e3:.2f} ms, device busy "
                  f"{100 * s['busy']:.1f}% ({s['busy_s'] * 1e3:.3f} ms), "
                  f"{s['launches_per_iter']:.1f} launches an iteration; "
                  f"top {top}", flush=True)
        out[score] = r
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("N", type=int, nargs="?", default=1024)
    p.add_argument("--genome", type=int, default=2_000_000)
    p.add_argument("--read-len", type=int, default=4000)
    p.add_argument("--et", type=int, default=200)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--profile", action="store_true",
                   help="one more run each under torch.profiler (a card)")
    add_device_arg(p)
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"torch_engine_prof: {e}", file=sys.stderr)
        return 2
    w = synthetic_calls(args.N, args.genome, args.read_len)
    profile_engine(dev, w, args.et, args.reps, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
