"""The benchmark's cell runner: set-up, the measured window, the check.

Everything that belongs to one cell is data found by name: the cell's
entry in BENCHMARK.json names its configuration (configs/<config>.json:
the deployment, its job kind, params.cfg values, engine, D-SOFT and
slots) and its traffic (workloads/<cell>.json: the length law, the
accuracy law and error mix, the pool of distinct inputs and the sample
the check compares).  Each per-layer metric is a reader in
metrics/<metric>.py.

The configuration's "job" names one of two job kinds:

* "self" (the default): a job is a whole read set through
  pipeline.run_pipeline (genome and banks, engine, seed table, D-SOFT,
  GACT, records), the reads against themselves, as a de novo overlap
  runs;
* "map": a job is one batch of reads against a reference that stays
  resident, as the CLI's --chunk-reads loop runs a chunk.  The reference
  is "reference": {"pieces": [<bp>, ...]}; set-up builds its genome and
  its seed table on the device (and the host engine's aligner), and the
  job takes the batch's banks, run_device_merged (or run_host) with
  same_file False and an engine built for the batch, and the records'
  formatting.

Jobs run back to back in a closed loop over a pool of inputs made from
the seed; the job in flight when the window ends is finished and counted.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np

from benchmark import importcheck, readgen
from benchmark.reference.overlap import Sample, records_of_samples

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
SEED_MASK = (1 << 64) - 1


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, spec: dict, here: Path = HERE) -> dict:
    """The cell's BENCHMARK.json entry, its configuration and its
    traffic, found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: {sorted(cells)}")
    cell = cells[name]
    with open(here / "configs" / f"{cell['config']}.json") as f:
        config = json.load(f)
    with open(here / "workloads" / f"{name}.json") as f:
        traffic = json.load(f)
    return dict(cell=cell, config=config, traffic=traffic)


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & SEED_MASK, *stream])


def job_kind(cfg: dict) -> str:
    """The configuration's job kind: "self" unless it names "map"."""
    kind = cfg.get("job", "self")
    if kind not in ("self", "map"):
        raise ValueError(f"job {kind!r}: self or map")
    return kind


class Inputs:
    """One job's input: read names, ASCII bases (flat) and lengths."""

    def __init__(self, names, flat, lengths):
        self.names = names
        self.flat = flat
        self.lengths = lengths
        self.starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        self.bases = int(lengths.sum())

    def seq(self, i: int) -> np.ndarray:
        s = self.starts[i]
        return self.flat[s:s + self.lengths[i]]

    def pairs(self):
        return [(n, self.seq(i)) for i, n in enumerate(self.names)]

    def prepare(self, prog: "Program"):
        """The reads as the program takes them, made in set-up: FASTA
        records, as a read set's file would give them."""
        text = self.flat.tobytes().decode("ascii")
        self.records = [prog.FastaRecord([n], text[s:s + ln])
                        for n, s, ln in zip(self.names, self.starts.tolist(),
                                            self.lengths.tolist())]


def make_data(cfg: dict, traffic: dict, seed: int, scale: dict | None = None):
    """(pieces, pool) from the seed.  pool is the [Inputs] of
    traffic["pool"] jobs.  The self job: read sets of one genome, and
    pieces None (the reads are the reference).  The map job: pieces
    [(name, ASCII bases)] of one reference, piece p named chr<p> and
    made from its own stream, and batches of reads drawn across the
    pieces in proportion to their lengths, a read of piece p named
    c<p>R<i>_<start>_<len>[_c].  scale overrides the genome length and
    length law (CPU rehearsals only)."""
    scale = scale or {}
    law = {**traffic["lengths"], **scale.get("lengths", {})}
    if job_kind(cfg) == "self":
        glen = scale.get("genome_length", cfg["genome_length"])
        g = readgen.genome(glen, rng(seed, 0))
        lengths = readgen.read_lengths(law, glen)
        pool = []
        for j in range(traffic["pool"]):
            names, flat, lens = readgen.reads(
                g, lengths, rng(seed, 1, j), traffic["accuracy"],
                traffic["ratio"], traffic["rc_fraction"])
            pool.append(Inputs(names, flat, lens))
        return None, pool
    sizes = cfg["reference"]["pieces"]
    codes = [readgen.genome(n, rng(seed, 0, p)) for p, n in enumerate(sizes)]
    lengths = readgen.read_lengths(law, sum(sizes))
    if lengths.max() > min(sizes):
        raise ValueError(f"a read of {lengths.max()} bp is longer than a "
                         f"piece of {min(sizes)} bp")
    counts = readgen.shares(len(lengths), sizes)
    ends = np.cumsum(counts)
    pool = []
    for j in range(traffic["pool"]):
        order = rng(seed, 1, j).permutation(lengths)
        parts = [readgen.reads(g, order[e - c:e], rng(seed, 1, j, p),
                               traffic["accuracy"], traffic["ratio"],
                               traffic["rc_fraction"])
                 for p, (g, c, e) in enumerate(zip(codes, counts, ends))]
        pool.append(Inputs(
            [f"c{p}{n}" for p, (names, _, _) in enumerate(parts)
             for n in names],
            np.concatenate([flat for _, flat, _ in parts]),
            np.concatenate([lens for _, _, lens in parts])))
    pieces = [(f"chr{p}", readgen.BASES[g]) for p, g in enumerate(codes)]
    return pieces, pool


def sample_reads(inputs: Inputs, check: dict, seed: int, j: int) -> list[int]:
    """The reads whose records the check compares: check["reads"] drawn
    from the seed, and the longest read where check["longest"]."""
    n = len(inputs.names)
    pick = rng(seed, 2, j).choice(n, size=min(n, check["reads"]),
                                  replace=False)
    ids = set(pick.tolist())
    if check.get("longest"):
        ids.add(int(np.argmax(inputs.lengths)))
    return sorted(ids)


def query_of(line: str) -> str:
    return line.split("query_id: ", 1)[1].split(",", 1)[0]


class Program:
    """The system under test: darwin_tpu_torch's pipeline, set up for one
    cell.  For the map job, set-up builds what the CLI builds before its
    chunk loop from the reference pieces: the genome, the seed table on
    the device and, for the host engine, the aligner."""

    def __init__(self, cfg: dict, device: str, pieces: list | None = None):
        from darwin_tpu_torch import pipeline
        from darwin_tpu_torch.config import Params
        from darwin_tpu_torch.io.fasta import FastaRecord
        from darwin_tpu_torch.spans import span

        self.pipeline, self.span = pipeline, span
        self.FastaRecord = FastaRecord
        self.cfg, self.device = cfg, device
        self.params = p = Params(**cfg["params"])
        self.kind = job_kind(cfg)
        if self.kind == "map":
            if cfg["engine"] not in ("device", "host"):
                raise ValueError(f"engine {cfg['engine']!r}: device or host")
            self.genome = pipeline.Genome(
                [FastaRecord([n], s.tobytes().decode("ascii"))
                 for n, s in pieces], p.bin_size)
            self.aligner = (pipeline.make_aligner(p, device)
                            if cfg["engine"] == "host" else None)
            self.table = pipeline.SeedTable.build(
                self.genome.concat, p.seed_size, p.seed_occurence_multiple,
                p.bin_size, p.window_size, device=device)

    def job(self, inputs: Inputs, metrics: dict) -> list[str]:
        cfg, reads = self.cfg, inputs.records
        if self.kind == "self":
            return self.pipeline.run_pipeline(
                reads, reads, self.params, True,
                batch_size=cfg["batch_size"], engine=cfg["engine"],
                dsoft=cfg["dsoft"], device=self.device,
                metrics=metrics).records
        pl = self.pipeline
        with self.span(metrics, "read_banks"):
            fwd, rev = pl.read_banks(reads)
        kw = dict(same_file=False, batch_size=cfg["batch_size"],
                  dsoft=cfg["dsoft"], metrics=metrics)
        if cfg["engine"] == "device":
            recs, _ = pl.run_device_merged(self.genome, self.table, fwd, rev,
                                           self.params, device=self.device,
                                           **kw)
        else:
            recs, _ = pl.run_host(self.genome, self.table, fwd, rev,
                                  self.params, aligner=self.aligner, **kw)
        with self.span(metrics, "format"):
            return pl.format_records(self.genome, reads, recs)


def check(cfg, traffic, pieces, pool, done, seed, device) -> dict:
    """Compare the window's records with the plain reference's on the
    sample of every input the window ran (done: [(pool index,
    records)]), as multisets; the samples of all inputs go through the
    reference together: for the self job each against its own reads,
    for the map job all against the one reference pieces, whose index
    the reference builds once."""
    used = sorted({j for j, _ in done})
    samples, names = [], {}
    for j in used:
        ids = sample_reads(pool[j], traffic["check"], seed, j)
        names[j] = {pool[j].names[i] for i in ids}
        reads = pool[j].pairs()
        samples.append(Sample(reads, reads, ids, True) if pieces is None
                       else Sample(pieces, reads, ids, False))
    stats = {}
    wants = dict(zip(used, map(collections.Counter, records_of_samples(
        samples, cfg["params"], device, stats=stats))))
    mismatches = compared = failed = 0
    for j, recs in done:
        got = collections.Counter(r for r in recs if query_of(r) in names[j])
        bad = sum(((got - wants[j]) + (wants[j] - got)).values())
        mismatches += bad
        failed += bad > 0
        compared += sum(wants[j].values())
    return dict(record_mismatches=mismatches, reference_records=compared,
                sampled_reads=sum(len(s.read_ids) for s in samples),
                failed_jobs=failed, reference=stats)


class Spans:
    """Wrappers installed on the program for a traced run: profiler
    ranges named after the layer each call belongs to, the DP calls'
    inputs (for their bound) and the engine loops' slots."""

    PHASES = (("genome_banks", "Genome"), ("banks", "read_banks"),
              ("engine_build", "make_merged_engine"),
              ("dsoft", "_seed"), ("format", "format_records"))

    def __init__(self):
        self.dp_calls = []
        self.loops = []
        self._undo = []

    def _patch(self, obj, attr, new):
        self._undo.append((obj, attr, obj.__dict__[attr]))
        setattr(obj, attr, new)

    def install(self):
        import torch
        from darwin_tpu_torch import pipeline
        from darwin_tpu_torch.engine import device_batch
        from darwin_tpu_torch.index.seed_table import SeedTable

        def ranged(name, fn):
            def wrapped(*a, **kw):
                with torch.profiler.record_function(f"bench:{name}"):
                    return fn(*a, **kw)
            return wrapped

        for name, attr in self.PHASES:
            self._patch(pipeline, attr, ranged(name, getattr(pipeline, attr)))
        build = SeedTable.__dict__["build"].__func__
        self._patch(SeedTable, "build", classmethod(ranged("table", build)))
        eng = device_batch.DeviceGactEngine
        for attr in ("run_async", "finish"):
            self._patch(eng, attr, ranged("align", eng.__dict__[attr]))
        loop = eng.__dict__["_loop"]
        spans = self

        def _loop(self, meta, cstate, drain):
            out = loop(self, meta, cstate, drain)
            spans.loops.append((self.slots(len(meta[0])), out.iters,
                                out.act_sum))
            return out
        self._patch(eng, "_loop", _loop)
        align = device_batch.align_tiles

        def align_tiles(ref, query, ref_len, query_len, **kw):
            out = align(ref, query, ref_len, query_len, **kw)
            B, T = ref.shape
            cell = next(v for k, v in out.items() if k.startswith("dir"))
            fixed = sum(t.numel() * t.element_size() for t in
                        (ref_len, query_len, *(v for k, v in out.items()
                                                if not k.startswith("dir"))))
            spans.dp_calls.append(dict(
                T=T, fixed_bytes=fixed, ref_len=ref_len, query_len=query_len,
                cell_bytes=cell.element_size() * cell.numel()
                / (B * T * (T + 1)) if B else 0))
            return out
        self._patch(device_batch, "align_tiles", align_tiles)

    def uninstall(self):
        for obj, attr, old in reversed(self._undo):
            setattr(obj, attr, old)
        self._undo.clear()


def profiled_window(prof) -> tuple[list, int, list, tuple]:
    """Device events [(name, start_ns, end_ns)], the launch count, the
    bench: ranges [(name, start_ns, end_ns)] and the window's (start,
    end) from a finished torch.profiler run."""
    from benchmark.roofline import LAUNCH_CALLS
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, ranges, launches, window = [], [], 0, None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda and not name.startswith("bench:"):
            dev.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name in LAUNCH_CALLS:
            launches += 1
        elif name.startswith("bench:") and e.device_type() != cuda:
            span = (name[6:], e.start_ns(), e.start_ns() + e.duration_ns())
            if span[0] == "window":
                window = span[1:]
            else:
                ranges.append(span)
    return dev, launches, ranges, window


def breakdown(dev, ranges, window) -> dict:
    """The ten device operations that took most time, and the ten
    longest idle gaps of the window named by the host's layer."""
    from benchmark.roofline import idle_gaps

    ops = collections.Counter()
    for name, s, e in dev:
        ops[name] += (e - s) / 1e9
    gaps = []
    for s, e in idle_gaps([(a, b) for _, a, b in dev], *window)[:10]:
        mid = (s + e) // 2
        inside = [r for r in ranges if r[1] <= mid <= r[2]]
        # The innermost range holds the gap's middle.
        name = min(inside, key=lambda r: r[2] - r[1])[0] if inside \
            else "harness"
        gaps.append([name, (e - s) / 1e9])
    return dict(device_ops=[[n, s] for n, s in ops.most_common(10)],
                idle_gaps=gaps)


def per_layer(spec: dict, cell_name: str, trace: dict) -> dict:
    """Every per-layer metric of BENCHMARK.json that lists this cell (or
    lists none), each read by metrics/<name>.py.  A reader that finds
    nothing returns None: off the card (a CPU rehearsal) the metric is
    left out; on the card the run fails, since a span, counter or kernel
    the reader needs has gone from the program's path."""
    out = {}
    for m in spec["per_layer"]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        v = reader.read(trace)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
        elif trace["on_card"]:
            raise SystemExit(f"per-layer metric {m['name']} read nothing "
                             f"in {cell_name}: its reader found no "
                             f"span, counter or kernel")
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", scale: dict | None = None,
             t_start: float | None = None, spec: dict | None = None,
             here: Path = HERE, log=sys.stderr) -> dict:
    """One run of a cell: set-up, the window, the check; returns the
    result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or load_spec()
    c = load_cell(name, spec, here)
    cfg, traffic = c["config"], c["traffic"]
    import torch
    # The port first: its import keeps numpy from madvising large arrays
    # into huge pages, whose first touch stalls on compaction.
    from darwin_tpu_torch import native

    if device == "cuda" and not native.available():
        raise SystemExit("the port's native host library did not build")
    t_imports = time.perf_counter()
    pieces, pool = make_data(cfg, traffic, seed, scale)
    t_data = time.perf_counter()
    prog = Program(cfg, device, pieces)
    for inputs in pool:
        inputs.prepare(prog)
    t_prog = time.perf_counter()
    # Warm-up: one job at the cell's own shapes (builds or loads the
    # kernels).
    prog.job(pool[0], {})
    print(f"setup: imports {t_imports - t_start:.3f} s, data "
          f"{t_data - t_imports:.3f} s, program "
          f"{t_prog - t_data:.3f} s, warm-up job "
          f"{time.perf_counter() - t_prog:.3f} s; {len(pool)} inputs of "
          f"{pool[0].bases / 1e6:.3f} Mbp", file=log, flush=True)
    found = importcheck.forbidden(sys.modules, importcheck.HARNESS)
    if found:
        raise SystemExit(f"modules that must not load: {found}")
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spans = prof = None
    if trace:
        spans = Spans()
        spans.install()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    window_cm = (torch.profiler.record_function("bench:window") if trace
                 else contextlib.nullcontext())
    done, sums, bases = [], collections.Counter(), 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with window_cm:
        while True:
            j = len(done) % len(pool)
            m = {}
            tj = time.perf_counter()
            recs = prog.job(pool[j], m)
            done.append((j, recs))
            bases += pool[j].bases
            sums.update({k: v for k, v in m.items()
                         if isinstance(v, (int, float))})
            t1 = time.perf_counter()
            print(f"job {len(done)}: input {j}, {t1 - tj:.3f} s, "
                  f"{len(recs)} records, " + ", ".join(
                      f"{k} {v:.4g}" for k, v in sorted(m.items())
                      if isinstance(v, (int, float))), file=log, flush=True)
            if t1 - t0 >= seconds:
                break
    if trace:
        prof.__exit__(None, None, None)
        spans.uninstall()
    window_s = t1 - t0
    found = importcheck.forbidden(sys.modules, importcheck.HARNESS)
    if found:
        raise SystemExit(f"modules that must not load: {found}")
    dev_info = dict(platform="gpu" if device == "cuda" else "cpu",
                    kind=(torch.cuda.get_device_name(0) if device == "cuda"
                          else "cpu"),
                    count=1,
                    memory_peak_bytes=(int(torch.cuda.max_memory_allocated())
                                       if device == "cuda" else 0))
    result = dict(correct=None, attempted=len(done), failed=0, metrics={},
                  device=dev_info)
    if trace:
        dev, launches, ranges, window = profiled_window(prof)
        del prof
        from benchmark.roofline import device_summary
        summary = device_summary(dev, launches, *window)
        tr = dict(cell=c, mbp=bases / 1e6, sums=dict(sums),
                  loops=spans.loops, dp_calls=spans.dp_calls,
                  device=summary, on_card=device == "cuda")
        result["metrics"] = per_layer(spec, name, tr)
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        result["breakdown"] = breakdown(dev, ranges, window)
        del dev, ranges, tr, spans
    else:
        result["metrics"] = {
            "read_mbp_per_s": {"value": bases / 1e6 / window_s,
                               "unit": "Mbp/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    # The check, once the program's state is freed.
    del prog
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ck = time.perf_counter()
    ck = check(cfg, traffic, pieces, pool, done, seed, device)
    print(f"check: {time.perf_counter() - t_ck:.3f} s; reference "
          + ", ".join(f"{k} {v:.4g}" for k, v in ck["reference"].items()),
          file=log)
    result["failed"] = ck["failed_jobs"]
    result["correct"] = (ck["record_mismatches"] == 0
                         and ck["reference_records"] >= 1)
    result["checks"] = {
        "record_mismatches": {"value": ck["record_mismatches"], "limit": 0},
        "reference_records": {"value": ck["reference_records"], "limit": 1}}
    print(f"check: {ck['sampled_reads']} sampled reads over "
          f"{len({j for j, _ in done})} inputs, {len(done)} jobs", file=log)
    print(f"record_mismatches: {ck['record_mismatches']} (limit: at most 0)",
          file=log)
    print(f"reference_records: {ck['reference_records']} (limit: at least "
          f"1)", file=log, flush=True)
    return result
