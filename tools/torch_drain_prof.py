"""The device engine's two-tier drain, off, auto and always, side by side.

The counterpart of tools/drain_prof.py and tools/drain_ecoli.py for
darwin_tpu_torch.  The default workload is skewed so that the drain's
gate engages at the CLI's geometry: a 4.6 Mb synthetic genome
(eval/datagen.synth_genome, seed 1), one read a call copied from it,
every 16th call on a 30 kb read and the rest on reads of 2-10 kb, each
call anchored mid-read; N = 1024 calls, 512 slots, T = 320, ET = 200,
threshold 35, scoring (1, -1, -1, -1).  With --ecoli it runs the
E.coli-shaped slice instead (4.6 Mb genome, 460 x 10 kb reads at 12%
error, seed 42, self-overlap, default params, 512 slots, through
pipeline.run_device_merged), where the gate stays off.

The modes run in turns (in_turns): one cold run each, then --reps
rounds of one run each, the order reversed every other round.  For each
mode it prints the gate's (tail, total), align_s (every warm run's and
their median), iterations, mean active slots over B, re-dispatches and
the record count, then whether the three record sets are equal, and a
JSON line of it all.  With --profile (a card only) it then runs each
mode once more under torch.profiler and prints the device time of the
run's kernels, the busy share of that run's align_s and the five
kernels with the most device time.  Exits 1 when the record sets
differ.

Usage:
    python tools/torch_drain_prof.py [--ecoli] [--device cuda] [--reps 3]
        [--profile] [--calls 1024] [--batch 512]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from darwin_tpu_torch.engine.batch import GactCalls  # noqa: E402
from darwin_tpu_torch.engine.device_batch import DeviceGactEngine  # noqa: E402
from darwin_tpu_torch.engine.seqbank import SeqBank  # noqa: E402
from darwin_tpu_torch.eval.datagen import (sample_reads,  # noqa: E402
                                           synth_genome)
from darwin_tpu_torch.index.genome import Genome  # noqa: E402
from darwin_tpu_torch.io.fasta import FastaRecord  # noqa: E402

# mode -> (drain, drain_gate): darwin_tpu's drain_enabled False, True
# (auto) and "always".
MODES = {"off": (False, True), "auto": (True, True),
         "always": (True, False)}
SCORING = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)


def skewed_workload(n_calls: int = 1024):
    """(genome, read bank, calls): the drain's skewed workload."""
    genome_len = 4_600_000
    rng = np.random.default_rng(1)
    genome_s = synth_genome(genome_len, rng)
    lens = rng.integers(2_000, 10_001, size=n_calls)
    lens[::16] = 30_000
    starts = rng.integers(0, genome_len - lens + 1)
    raw = np.frombuffer(genome_s.encode(), dtype=np.uint8)
    bank = SeqBank([raw[s:s + n] for s, n in zip(starts, lens)])
    mid = lens // 2
    calls = GactCalls(ref_id=np.zeros(n_calls, np.int64),
                      query_id=np.arange(n_calls, dtype=np.int64),
                      ref_pos=(starts + mid).astype(np.int64),
                      query_pos=mid.astype(np.int64))
    return Genome([FastaRecord(["ref"], genome_s)], 64), bank, calls


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_engine(genome, bank, dev, batch: int = 512) -> DeviceGactEngine:
    """The skewed workload's engine (drain and gate on)."""
    return DeviceGactEngine(genome, bank, tile_size=320, early_terminate=200,
                            first_tile_score_threshold=35, same_file=False,
                            batch_size=batch, device=dev, **SCORING)


def in_turns(eng, run_once, reps: int) -> dict:
    """{mode: result} of run_once() under each mode of eng: one cold run
    of each mode, then reps rounds that run every mode once, the order
    reversed every other round (off, auto, always; always, auto, off;
    ...).  run_once returns (records, align_s).  A result holds the warm
    runs' align_s, their median, the last run's iterations, active
    slot-iterations, re-dispatches and gate's (tail, total), and the
    record set."""
    modes = list(MODES)
    times = {m: [] for m in modes}
    out = {}
    for rnd in range(reps + 1):
        for mode in (modes if rnd % 2 == 0 else modes[::-1]):
            eng.drain, eng.drain_gate = MODES[mode]
            recs, align_s = run_once()
            if rnd:
                times[mode].append(align_s)
            out[mode] = dict(
                iters=eng.last_iters, active_sum=eng.last_active_sum,
                mean_active_over_B=(eng.last_active_sum
                                    / max(1, eng.last_iters)
                                    / eng.batch_size),
                redispatches=eng.last_drain_redispatches,
                gate=eng.last_drain_gate, records=record_set(recs))
    eng.drain = eng.drain_gate = True
    for mode, r in out.items():
        r["align_s"] = times[mode]
        r["align_s_median"] = (statistics.median(times[mode])
                               if times[mode] else None)
    return out


def profiled(eng, run_once) -> dict:
    """{mode: device time} of one run_once() a mode under torch.profiler:
    the kernels' device ms summed, its share of the run's align_s, and
    the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for mode, flags in MODES.items():
        eng.drain, eng.drain_gate = flags
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, align_s = run_once()
        kernels = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0)
            if us > 0 and e.device_type.name == "CUDA":
                kernels.append((us / 1e3, e.key[:60], e.count))
        kernels.sort(reverse=True)
        dev_ms = sum(k[0] for k in kernels)
        out[mode] = dict(device_ms=dev_ms, align_s=align_s,
                         busy=dev_ms / 1e3 / align_s, top=kernels[:5])
        print(f"drain {mode}, profiled: kernels' device time {dev_ms:.4f} ms "
              f"of align_s {align_s:.4f} s (busy {out[mode]['busy']:.4f}); "
              f"top {kernels[:5]}", flush=True)
    eng.drain = eng.drain_gate = True
    return out


def engine_run(eng: DeviceGactEngine, calls):
    """run_once for in_turns: the calls through eng, align_s the host
    clock around run_async and finish."""
    def run_once():
        _sync(eng.device)
        t0 = time.perf_counter()
        recs = eng.finish(eng.run_async(calls, False))
        return recs, time.perf_counter() - t0
    return run_once


def engine_modes(eng: DeviceGactEngine, calls, reps: int = 3) -> dict:
    """in_turns over the calls through eng."""
    return in_turns(eng, engine_run(eng, calls), reps)


def record_set(recs) -> set:
    """The records as a set of field tuples."""
    return {dataclasses.astuple(r) for r in recs}


def ecoli_run(dev):
    """(engine, run_once) of the E.coli-shaped slice through the
    merged-strand engine of pipeline.run_device_merged (align_s its
    metric)."""
    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.index.seed_table import SeedTable
    from darwin_tpu_torch.pipeline import (make_merged_engine, read_banks,
                                           run_device_merged)

    rng = np.random.default_rng(42)
    reads = [FastaRecord([name], seq) for name, seq in sample_reads(
        synth_genome(4_600_000, rng), 460, 10_000, rng, error_rate=0.12,
        rc_fraction=0.5)]
    params = Params()
    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    fwd, rev = read_banks(reads)
    prebuilt = make_merged_engine(genome, fwd, rev, params, same_file=True,
                                  batch_size=512, device=dev)

    def run_once():
        m: dict = {}
        recs, _ = run_device_merged(genome, table, fwd, rev, params,
                                    same_file=True, batch_size=512,
                                    prebuilt=prebuilt, metrics=m)
        return recs, m["align_s"]

    return prebuilt[0], run_once


def report(results: dict) -> bool:
    """Print each mode's line; True when the record sets are equal."""
    for mode, r in results.items():
        print(f"drain {mode}: gate (tail, total) {r['gate']}, align_s "
              f"median {r['align_s_median']} of {r['align_s']}, iterations "
              f"{r['iters']}, active slot-iterations {r['active_sum']}, "
              f"mean active/B {r['mean_active_over_B']:.4f}, re-dispatches "
              f"{r['redispatches']}, records {len(r['records'])}",
              flush=True)
    sets = [r["records"] for r in results.values()]
    same = all(s == sets[0] for s in sets)
    print(f"record sets {'equal' if same else 'DIFFER'}", flush=True)
    return same


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ecoli", action="store_true",
                   help="the E.coli-shaped slice instead of the skewed "
                        "workload")
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--profile", action="store_true",
                   help="then one run a mode under torch.profiler")
    p.add_argument("--calls", type=int, default=1024)
    p.add_argument("--batch", type=int, default=512)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_drain_prof: no CUDA device (give --device cpu)",
              file=sys.stderr)
        return 2
    if args.ecoli:
        eng, run_once = ecoli_run(dev)
    else:
        genome, bank, calls = skewed_workload(args.calls)
        eng = make_engine(genome, bank, dev, args.batch)
        run_once = engine_run(eng, calls)
    results = in_turns(eng, run_once, args.reps)
    same = report(results)
    if args.profile:
        for mode, prof in profiled(eng, run_once).items():
            results[mode]["profiled"] = prof
    print(json.dumps({"workload": "ecoli" if args.ecoli else "skewed",
                      "records_equal": same, **{
                          m: {k: v for k, v in r.items() if k != "records"}
                          for m, r in results.items()}}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
