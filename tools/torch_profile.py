"""Profiling harness of the port: torch.profiler traces, phase timing, GCUPS.

    python3 tools/torch_profile.py kernel [B] [T] [--reps 3]
        [--trace-dir DIR] [--device cuda|cpu]
    python3 tools/torch_profile.py pipeline REF.fasta READS.fasta
        [--params params.cfg] [--batch-size 512] [--reps 3]
        [--engine device|host] [--dsoft host|device] [--trace-dir DIR]
        [--device cuda|cpu]

The counterpart of tools/profile.py.  `kernel` times the packed6 DP
(csrc/dp.cu) and the packed6 walker (csrc/traceback_words.cu) on B full
T x T tiles at early_terminate 200, profile.py's step and inputs (seed
0, 10% of the query bases redrawn, no first tiles), timed by
darwin_tpu_torch.bench.chained_ms (CUDA events, the median of --reps
steps after a warm-up step, each step's sink checked); it prints
ms/step and GCUPS (B*T*T cells a step) and the step's sink (profile.py's
sum, int32-wrapped).
`pipeline` runs darwin_tpu_torch.pipeline.run_pipeline on the FASTA
files once to warm up, then keeps the best of --reps runs, each with
metrics=: it prints reads/s, records, candidates and the phase split.
The phases summed are the disjoint ones of PHASES (genome_banks_s,
engine_build_s, table_s, seed_s, align_s, format_s); "other" is the
wall less their sum.  Under each phase the program's spans inside it
(SPANS: genome_s and read_banks_s; dsoft_index_s; engine_prepare_s,
engine_enqueue_s, engine_wait_s and engine_records_s) are printed
indented, with the phase's rest; they are not summed again.  The
metrics' counts (engine_iters, engine_slot_iters, ...) are printed
apart.  The engine is --engine's (default device; profile.py takes the
device engine on a TPU and the host engine elsewhere).

With --trace-dir the timed steps or runs go under torch.profiler (the
counterpart of jax.profiler.trace), whose Chrome trace is written to
DIR/trace.json (chrome://tracing or Perfetto).  The program's host
stages are ranges named darwin.<span> in it (darwin_tpu_torch.spans),
on the clock of the device's events, so each idle stretch of the device
lies against the stage under it.  On a card it then prints the device's
busy and idle share of the window (the timed steps, or the runs'
align_s and wall; busy is the union of the device events' intervals,
device-side annotations of darwin.* ranges left out), the device time
by kernel and the kernel launches a step or an engine iteration
(device_summary, which tools/torch_profile_ecoli.py and
tools/torch_engine_prof.py use too).  A CPU run traces host events only
and reports no device share.

Without a card and without --device cpu it exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import darwin_tpu_torch  # noqa: F401,E402  (THP madvise guard)
import torch  # noqa: E402

from darwin_tpu_torch.lab import add_device_arg, resolve_device  # noqa: E402
from darwin_tpu_torch.spans import PREFIX  # noqa: E402

# run_pipeline's disjoint phases, in the order they run.
PHASES = ("genome_banks_s", "engine_build_s", "table_s", "seed_s",
          "align_s", "format_s")
# The program's spans inside a phase.
SPANS = {"genome_banks_s": ("genome_s", "read_banks_s"),
         "seed_s": ("dsoft_index_s",),
         "align_s": ("engine_prepare_s", "engine_enqueue_s",
                     "engine_wait_s", "engine_records_s")}
KERNEL_ET = 200
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def tracing(trace_dir, device: torch.device):
    """torch.profiler over the block when trace_dir is given (yields the
    profile, else None); then writes trace_dir/trace.json."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    path = Path(trace_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / TRACE_FILE))
    print(f"trace written to {path / TRACE_FILE}", file=sys.stderr)


def union_us(intervals) -> float:
    """Microseconds covered by the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_summary(prof, window_s: float, iters: int) -> dict:
    """The device's time in a profiled window of window_s seconds over
    iters steps or engine iterations: busy_s (the union of the device
    events' intervals, so that work overlapping on two streams counts
    once), busy (its share of window_s), launches (the kernel-launch
    calls), launches_per_iter and kernels, [(name, seconds summed,
    count)] most device time first.  The device-side annotations of the
    program's darwin.* ranges are not device work and are left out."""
    busy = defaultdict(float)
    count = defaultdict(int)
    spans = []
    launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(PREFIX):
                continue
            busy[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name in LAUNCH_CALLS:
            launches += 1
    total = union_us(spans) / 1e6
    return dict(busy_s=total, busy=total / window_s, launches=launches,
                launches_per_iter=launches / max(1, iters),
                kernels=[(k, v / 1e6, count[k]) for k, v in
                         sorted(busy.items(), key=lambda kv: -kv[1])])


def kernel_lines(summary: dict) -> list[str]:
    """One line a kernel: device ms, share, launches, ms each, name."""
    total = summary["busy_s"]
    return [f"{s * 1e3:10.3f} ms {100 * s / total:5.1f}% {n:7d}x "
            f"{s / n * 1e3:9.4f} ms each  {k[:100]}"
            for k, s, n in summary["kernels"]]


def report_trace(prof, device: torch.device, window_s: float, iters: int,
                 what: str) -> dict | None:
    """Print device_summary of a traced window (a card only); returns
    it, or None on a CPU."""
    if device.type != "cuda":
        print("trace: a CPU run, host events only; device share not "
              "measured", flush=True)
        return None
    s = device_summary(prof, window_s, iters)
    print(f"device busy {s['busy_s']:.6f} s = {100 * s['busy']:.1f}% of "
          f"{what} ({window_s:.6f} s), idle {100 - 100 * s['busy']:.1f}%; "
          f"{s['launches']} kernel launches = {s['launches_per_iter']:.1f} "
          f"per iteration over {iters}", flush=True)
    print("device time by kernel (top 12):")
    print("\n".join(kernel_lines(s)[:12]), flush=True)
    return s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_kernel(device: torch.device, B: int = 2048, T: int = 320,
                   reps: int = 3, trace_dir=None) -> dict:
    """profile.py's kernel mode: {B, T, ms (a step), gcups, sink (one
    step's), summary (device_summary or None)}."""
    from darwin_tpu_torch import bench

    b = bench.Batches(device, B, T, 1)
    b.firsts.zero_()

    def step(v):
        return bench.one_step(b, v, KERNEL_ET)

    step(0)  # builds the kernels outside the trace
    with tracing(trace_dir, device) as prof:
        ms, sink = bench.chained_ms(b, step, device, passes=reps)
    gcups = B * T * T / ms / 1e6
    print(f"kernel: B={B} T={T} {ms:.4f} ms/step {gcups:.4f} GCUPS "
          f"(sink {sink})", flush=True)
    steps = reps + 1  # chained_ms's warm-up pass is traced too
    summary = (report_trace(prof, device, ms * steps / 1e3, steps,
                            f"{steps} steps (the median step's time x "
                            f"{steps})") if prof else None)
    return dict(B=B, T=T, ms=ms, gcups=gcups, sink=sink, summary=summary)


def profile_pipeline(device: torch.device, reference: str, reads: str,
                     params_path: str | None = None,
                     batch_size: int = 512, reps: int = 3,
                     engine: str = "device", dsoft: str = "host",
                     trace_dir=None) -> dict:
    """profile.py's pipeline mode: {wall (the best run's), records,
    candidates, metrics (the best run's), phases_s (PHASES summed),
    summary (device_summary or None)}."""
    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.io.fasta import parse_fasta
    from darwin_tpu_torch.pipeline import run_pipeline

    params = (Params.from_cfg(params_path)
              if params_path and Path(params_path).exists() else Params())
    same = reference == reads
    ref = parse_fasta(reference)
    qry = ref if same else parse_fasta(reads)
    kw = dict(same_file=same, engine=engine, dsoft=dsoft,
              batch_size=batch_size, device=device)
    run_pipeline(ref, qry, params, **kw)  # builds the kernels
    runs = []
    with tracing(trace_dir, device) as prof:
        for _ in range(max(1, reps)):
            m: dict = {}
            _sync(device)
            t0 = time.perf_counter()
            res = run_pipeline(ref, qry, params, metrics=m, **kw)
            _sync(device)
            runs.append((time.perf_counter() - t0, m, res))
    dt, m, res = min(runs, key=lambda r: r[0])
    phases = {k: m[k] for k in PHASES if k in m}
    accounted = sum(phases.values())
    cands = res.num_candidates_for + res.num_candidates_rev
    print(f"pipeline: {len(qry)} reads in {dt:.4f} s "
          f"({len(qry) / dt:.1f} reads/s), {len(res.records)} records, "
          f"{cands} candidates (engine {engine}, D-SOFT {dsoft})")
    split = "  ".join(f"{k[:-2]} {v:.4f}" for k, v in phases.items())
    print(f"phases (best of {len(runs)}, s): {split}  other "
          f"{dt - accounted:.4f}")
    print("\n".join(span_lines(m)))
    counts = {k: v for k, v in m.items() if not k.endswith("_s")}
    print(f"counts: {counts}", flush=True)
    summary = None
    if prof:
        iters = sum(r[1].get("engine_iters", 0) for r in runs)
        wall = sum(r[0] for r in runs)
        summary = report_trace(prof, device,
                               sum(r[1]["align_s"] for r in runs), iters,
                               f"the {len(runs)} runs' align_s")
        if summary:
            print(f"device busy {100 * summary['busy_s'] / wall:.1f}% of "
                  f"the runs' wall ({wall:.6f} s)", flush=True)
    return dict(wall=dt, records=res.records, candidates=cands, metrics=m,
                phases_s=accounted, summary=summary)


def span_lines(m: dict) -> list[str]:
    """Each phase of m that holds spans, then its spans indented and
    the phase's rest."""
    out = []
    for phase, spans in SPANS.items():
        inner = {k: m[k] for k in spans if k in m}
        if phase not in m or not inner:
            continue
        out.append(f"  {phase[:-2]} {m[phase]:.4f} s:")
        out += [f"    {k[:-2]} {v:.4f}" for k, v in inner.items()]
        out.append(f"    rest {m[phase] - sum(inner.values()):.4f}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kernel")
    k.add_argument("B", type=int, nargs="?", default=2048)
    k.add_argument("T", type=int, nargs="?", default=320)
    e = sub.add_parser("pipeline")
    e.add_argument("reference")
    e.add_argument("reads")
    e.add_argument("--params", default="params.cfg")
    e.add_argument("--batch-size", type=int, default=512)
    e.add_argument("--engine", choices=("device", "host"), default="device")
    e.add_argument("--dsoft", choices=("host", "device"), default="host")
    for sp in (k, e):
        sp.add_argument("--reps", type=int, default=3)
        sp.add_argument("--trace-dir", default=None)
        add_device_arg(sp)
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as err:
        print(f"torch_profile: {err}", file=sys.stderr)
        return 2
    if args.mode == "kernel":
        profile_kernel(dev, args.B, args.T, args.reps, args.trace_dir)
    else:
        profile_pipeline(dev, args.reference, args.reads, args.params,
                         args.batch_size, args.reps, args.engine,
                         args.dsoft, args.trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
