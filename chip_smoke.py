#!/usr/bin/env python3
"""Drive the PyTorch port (darwin_tpu_torch) on one CUDA card and check
every part of its main path.

    python3 chip_smoke.py

Phases; any failure ends the run with a nonzero exit code:

1. device: the card's name and power limit; the kernels are built from
   darwin_tpu_torch/csrc (nvcc, sm_90a) and the build time printed;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, bit-exact (every output is an integer), at B = 512 and
   T = 320, 64, 376 under three scoring sets, with kernel and plain
   times (CUDA events, median) at the main path's shape;
3. fixtures: darwin_tpu_torch.pipeline.run_pipeline on every
   tests/data fixture that has an out.darwin (the reference binary's
   output); record sets must be equal;
4. the E.coli-shaped slice through the port's CLI: a 4.6 Mb synthetic
   genome, 460 x 10 kb reads at 12% error (seed 42), self-overlap,
   default params, 512 slots.  The reads' sha256 must equal
   tests/data/ecoli_shape/dataset.sha256 and the merged records
   tests/data/ecoli_shape/jax_cpu.darwin (darwin_tpu's own output on a
   CPU), and the host stages must have run the port's native library
   (--metrics-json's host_native), not their NumPy fallbacks.  The
   kernels' launch counters are zeroed just before this phase and must
   all be nonzero after it;
5. the kernel lab (darwin_tpu_torch.lab): with the counters zeroed
   again, its geometry sweep (every dir format and interleave 1, 2, 4,
   each output checked bit-exact against the plain version), the `ilp`
   experiment in every format, the plane-2 probe's emit at B = 2048,
   T = 376 and the scan probe at TJP = 384 with its cross-check; every
   DP variant, the plane-2 kernel and both scan lowerings must have
   launched.  Then each of them against its plain version: the DP
   variants and plane 2 at TILES x SCORINGS (B = 512, tiles with
   rlen < T), plane 2 also at B = 2048, T = 376, the scans at
   B = 2048, TJP = 384; with kernel and plain times (CUDA events,
   median): the DP variants at B = 512, T = 320, plane 2 and the scans
   at B = 2048.

The last three lines are a JSON summary of the kernels, nvidia-smi's
name and power limit, and {"ok": true, "device": {...}}.  Without a
CUDA device it prints no result and exits 1.  It imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DATA = REPO / "tests" / "data"
B_MAIN, T_MAIN = 512, 320
# (tile size, early_terminate): the default params, tests/data/tiny,
# configs/tpu.cfg.
TILES = [(320, 200), (64, 40), (376, 256)]
SCORINGS = [(1, -1, -1, -1), (2, -3, -4, -2), (3, -1, -2, -1)]


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median device time of fn() over reps runs, after one warm-up."""
    import torch

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
    return statistics.median(times)


def related_tiles(rng, B: int, T: int):
    """[B, T] ref/query tiles of related ACGT (about 5% each of
    substitutions, insertions and deletions), random lengths in 1..T,
    padded; lanes 0-2 are the edge cases (idle slot, empty ref, empty
    query)."""
    import numpy as np

    from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = np.full((B, T), PAD_REF, dtype=np.uint8)
    query = np.full((B, T), PAD_QUERY, dtype=np.uint8)
    rlen = rng.integers(1, T + 1, size=B).astype(np.int32)
    qlen = rng.integers(1, T + 1, size=B).astype(np.int32)
    rlen[0] = qlen[0] = rlen[1] = qlen[2] = 0
    for b in range(B):
        src = acgt[rng.integers(0, 4, size=2 * T)]
        q = src[rng.random(2 * T) >= 0.05].copy()
        sub = rng.random(len(q)) < 0.05
        q[sub] = acgt[rng.integers(0, 4, size=int(sub.sum()))]
        at = np.flatnonzero(rng.random(len(q)) < 0.05)
        q = np.insert(q, at, acgt[rng.integers(0, 4, size=len(at))])
        ref[b, :rlen[b]] = src[:rlen[b]]
        query[b, :qlen[b]] = q[:qlen[b]]
    return ref, query, rlen, qlen


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the card; returns
    {kernel: {max_abs_err, ms, plain_ms}}."""
    import numpy as np
    import torch

    from darwin_tpu_torch.lab.geom_sweep import max_abs_err
    from darwin_tpu_torch.ops.common import PAD_REF
    from darwin_tpu_torch.ops.dp import align_tiles
    from darwin_tpu_torch.ops.reference_dp import align_tiles_torch
    from darwin_tpu_torch.ops.tile_fetch import fetch_tiles, fetch_tiles_torch
    from darwin_tpu_torch.ops.traceback import traceback, traceback_torch

    rng = np.random.default_rng(0)
    res = {k: {"max_abs_err": 0} for k in ("dp", "traceback", "fetch")}
    for T, ET in TILES:
        ref, query, rlen, qlen = (torch.from_numpy(x).to(dev) for x in
                                  related_tiles(rng, B_MAIN, T))
        first = torch.from_numpy(rng.random(B_MAIN) < 0.5).to(dev)
        for sc in SCORINGS:
            kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                          sc))
            got = align_tiles(ref, query, rlen, qlen, **kw)
            want = align_tiles_torch(ref, query, rlen, qlen, **kw)
            e_dp = max_abs_err(got, want)
            tb_args = (got["dir"], rlen, qlen, first, got["max_i"],
                       got["max_j"])
            g_tb = traceback(*tb_args, early_terminate=ET)
            w_tb = traceback_torch(*tb_args, early_terminate=ET)
            e_tb = max_abs_err(dict(enumerate(g_tb)), dict(enumerate(w_tb)))
            log(f"  T={T} ET={ET} scoring={sc}: dp err {e_dp}, "
                f"traceback err {e_tb}, mean walk "
                f"{float((g_tb[1] + g_tb[2]).float().mean()):.1f} steps")
            if e_dp or e_tb:
                raise AssertionError(f"kernel mismatch at T={T} {sc}")
            res["dp"]["max_abs_err"] = max(res["dp"]["max_abs_err"], e_dp)
            res["traceback"]["max_abs_err"] = max(
                res["traceback"]["max_abs_err"], e_tb)
            if (T, sc) == (T_MAIN, SCORINGS[0]):
                main_dp = (ref, query, rlen, qlen, kw, tb_args, ET)

    # Span fetch over a bank the size of the E.coli-shaped genome, with
    # offsets that straddle both ends of it.
    n = 4_600_000
    bank = torch.from_numpy(np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=n)]).to(dev)
    for T, _ in TILES:
        start = rng.integers(-T, n + T, size=B_MAIN)
        start[:4] = [-10**9, 10**12, n - 5, -3]
        length = rng.integers(0, T + 1, size=B_MAIN).astype(np.int32)
        args = (bank, torch.from_numpy(start).to(dev),
                torch.from_numpy(length).to(dev),
                torch.from_numpy(rng.random(B_MAIN) < 0.5).to(dev))
        got = fetch_tiles(*args, T=T, pad=PAD_REF)
        want = fetch_tiles_torch(*args, T=T, pad=PAD_REF)
        e = max_abs_err({0: got}, {0: want})
        log(f"  fetch T={T}: err {e}")
        if e:
            raise AssertionError(f"fetch mismatch at T={T}")
        if T == T_MAIN:
            main_fetch = (args, T)
        res["fetch"]["max_abs_err"] = max(res["fetch"]["max_abs_err"], e)

    ref, query, rlen, qlen, kw, tb_args, ET = main_dp
    fa, T = main_fetch
    timed = {
        "dp": (lambda: align_tiles(ref, query, rlen, qlen, **kw),
               lambda: align_tiles_torch(ref, query, rlen, qlen, **kw)),
        "traceback": (lambda: traceback(*tb_args, early_terminate=ET),
                      lambda: traceback_torch(*tb_args, early_terminate=ET)),
        "fetch": (lambda: fetch_tiles(*fa, T=T, pad=PAD_REF),
                  lambda: fetch_tiles_torch(*fa, T=T, pad=PAD_REF)),
    }
    for name, (kernel, plain) in timed.items():
        res[name]["ms"] = median_ms(kernel, 20)
        res[name]["plain_ms"] = median_ms(plain, 5)
        log(f"  {name} at B={B_MAIN} T={T_MAIN}: kernel "
            f"{res[name]['ms']:.4f} ms, plain {res[name]['plain_ms']:.4f} ms")
    return res


def phase_fixtures(dev) -> None:
    from darwin_tpu.config import Params
    from darwin_tpu_torch.pipeline import read_fasta, run_pipeline

    fixtures = sorted(p.parent for p in DATA.glob("*/out.darwin"))
    if not fixtures:
        raise AssertionError(f"no fixtures under {DATA}")
    for d in fixtures:
        params = Params.from_cfg(d / "params.cfg")
        reads = read_fasta(d / "reads.fasta")
        same_file = not (d / "ref.fasta").exists()
        ref = reads if same_file else read_fasta(d / "ref.fasta")
        t0 = time.perf_counter()
        res = run_pipeline(ref, reads, params, same_file, batch_size=64,
                           device=dev)
        want = set((d / "out.darwin").read_text().splitlines())
        got = set(res.records)
        log(f"  {d.name}: {len(got)}/{len(want)} records, "
            f"{time.perf_counter() - t0:.2f} s")
        if got != want:
            raise AssertionError(
                f"{d.name}: missing {sorted(want - got)[:3]} extra "
                f"{sorted(got - want)[:3]}")


def ecoli_reads() -> list:
    """The E.coli-shaped dataset (tools/ecoli_shape.py makes the same)."""
    import numpy as np

    from darwin_tpu.eval.datagen import sample_reads, synth_genome

    rng = np.random.default_rng(42)
    genome = synth_genome(4_600_000, rng)
    return sample_reads(genome, 460, 10_000, rng, error_rate=0.12,
                        rc_fraction=0.5)


def phase_ecoli(counters) -> dict:
    from darwin_tpu.io.fasta import write_fasta
    from darwin_tpu_torch import cli

    want_sha = (DATA / "ecoli_shape" / "dataset.sha256").read_text().strip()
    want = (DATA / "ecoli_shape" / "jax_cpu.darwin").read_text()
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        fa = td / "reads.fasta"
        t0 = time.perf_counter()
        write_fasta(fa, ecoli_reads())
        sha = hashlib.sha256(fa.read_bytes()).hexdigest()
        log(f"  dataset made in {time.perf_counter() - t0:.1f} s, "
            f"sha256 {sha}")
        if sha != want_sha:
            raise AssertionError(f"dataset sha256 {sha} != {want_sha}")
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        # No params.cfg in td: the reference's default params.
        rc = cli.main([str(fa), str(fa), "--params", str(td / "params.cfg"),
                       "--batch-size", "512", "--out-dir", str(td / "out"),
                       "--merged-out", str(td / "merged.darwin"),
                       "--metrics-json", str(td / "metrics.json")])
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        if rc != 0:
            raise AssertionError(f"cli exited {rc}")
        got = (td / "merged.darwin").read_text()
        m = json.loads((td / "metrics.json").read_text())
    n_got = len(got.splitlines())
    log(f"  records {n_got} (expected {len(want.splitlines())}), "
        f"wall {wall:.3f} s, seed_s {m['seed_s']:.3f}, align_s "
        f"{m['align_s']:.3f}, seed table {m['seed_table_s']:.3f} s, "
        f"engine iterations {m['engine_iters']}, mean active slots "
        f"{m['engine_active_sum'] / max(1, m['engine_iters']):.1f}, "
        f"reads/s {m['reads_per_s']:.1f}, candidates "
        f"{m['num_candidates']}")
    log(f"  launches: {launches}; host_native {m['host_native']}")
    if m["host_native"] is not True:
        raise AssertionError("the host stages ran their NumPy fallbacks: "
                             "darwin_tpu_torch.native did not build")
    if got != want:
        w, g = set(want.splitlines()), set(got.splitlines())
        raise AssertionError(f"E.coli records differ: missing "
                             f"{sorted(w - g)[:3]} extra {sorted(g - w)[:3]}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


def _dp_variant(fmt: str, il: int) -> tuple[str, str]:
    """(JSON name, the TPU kernel it replaces) of one DP variant."""
    if il == 1:
        name = "align_tiles" if fmt == "bytes" else f"align_tiles[{fmt}]"
        return name, "darwin_tpu/ops/pallas_dp.py:523"
    return f"align_tiles[{fmt},il={il}]", "darwin_tpu/ops/pallas_dp.py:493"


# The DP kernel's variants, by (dir_format, interleave).
DP_VARIANTS = {(fmt, il): _dp_variant(fmt, il)
               for fmt in ("bytes", "packed", "packed6") for il in (1, 2, 4)}
LAB_KERNELS = {
    "plane2": ("darwin_tpu_torch/csrc/dp.cu", "tools/plane2_probe.py:209"),
    "scanshift_shfl": ("darwin_tpu_torch/csrc/scanshift.cu",
                       "tools/scanshift_probe.py:97"),
    "scanshift_smem": ("darwin_tpu_torch/csrc/scanshift.cu",
                       "tools/scanshift_probe.py:97"),
}


def phase_lab(dev):
    """The kernel lab's path with zeroed counters, then each lab kernel
    against its plain version.  Returns ({name: {max_abs_err, ms,
    plain_ms}}, {name: launches})."""
    import numpy as np
    import torch

    from darwin_tpu_torch.lab import (SCORING, geom_sweep, kernel_lab,
                                      plane2_probe, related_batches,
                                      scanshift_probe)
    from darwin_tpu_torch.lab.geom_sweep import max_abs_err
    from darwin_tpu_torch.ops.dp import PACKERS, align_tiles, align_tiles_plain
    from darwin_tpu_torch.ops.plane2 import plane2, plane2_torch
    from darwin_tpu_torch.ops.reference_dp import align_tiles_torch
    from darwin_tpu_torch.ops.scanshift import (scanshift_shfl,
                                                scanshift_smem,
                                                scanshift_torch)

    scans = {"scanshift_shfl": scanshift_shfl,
             "scanshift_smem": scanshift_smem}
    counters = (align_tiles, plane2, *scans.values())
    for c in counters:
        c.launches = 0
    align_tiles.variant_launches.clear()
    rows = geom_sweep.sweep(geom_sweep.DEFAULT_MATRIX, dev)
    bad = [r[:4] for r in rows if r[4]["max_abs_err"]]
    if bad:
        raise AssertionError(f"geometry sweep mismatch: {bad}")
    lab = kernel_lab.Lab(dev, B=2048, T=320, ET=200, V=2)
    for fmt in PACKERS:
        lab.run("ilp", fmt)
    plane2_probe.probe_emit(376, dev, B=2048, V=2)
    scanshift_probe.run(376, dev, B=2048, V=8)
    launches = {name: align_tiles.variant_launches[v]
                for v, (name, _) in DP_VARIANTS.items()}
    launches["plane2"] = plane2.launches
    launches.update({k: f.launches for k, f in scans.items()})
    log(f"  lab launches: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a lab kernel was not launched: {launches}")

    res = {}
    rng = np.random.default_rng(5)
    for T, _ in TILES:
        ref, query, rlen, qlen = (torch.from_numpy(x).to(dev) for x in
                                  related_tiles(rng, B_MAIN, T))
        for sc in SCORINGS:
            kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                          sc))
            plain_out = align_tiles_torch(ref, query, rlen, qlen, **kw)
            for fmt, packer in PACKERS.items():
                want = dict(plain_out)
                if packer is not None:
                    want["dir_words"] = packer(want.pop("dir"))
                for il in (1, 2, 4):
                    got = align_tiles(ref, query, rlen, qlen, dir_format=fmt,
                                      interleave=il, **kw)
                    name = DP_VARIANTS[(fmt, il)][0]
                    e = max_abs_err(got, want)
                    res.setdefault(name, {"max_abs_err": 0})
                    res[name]["max_abs_err"] = max(
                        res[name]["max_abs_err"], e)
                    if e:
                        raise AssertionError(f"{name} mismatch at T={T} {sc}")
            p2 = plane2(ref, query, rlen, qlen, **kw)
            e = max_abs_err(p2, plane2_torch(ref, query, rlen, qlen, **kw))
            res.setdefault("plane2", {"max_abs_err": 0})
            res["plane2"]["max_abs_err"] = max(res["plane2"]["max_abs_err"],
                                               e)
            if e:
                raise AssertionError(f"plane2 mismatch at T={T} {sc}")
            if (T, sc) == (T_MAIN, SCORINGS[0]):
                main_dp = (ref, query, rlen, qlen, kw)
        log(f"  T={T}: every DP variant and plane 2 exact under "
            f"{len(SCORINGS)} scorings")

    ref, query, rlen, qlen, kw = main_dp
    for fmt in PACKERS:
        plain_ms = median_ms(lambda: align_tiles_plain(
            ref, query, rlen, qlen, dir_format=fmt, **kw), 5)
        for il in (1, 2, 4):
            name = DP_VARIANTS[(fmt, il)][0]
            res[name]["ms"] = median_ms(
                lambda: align_tiles(ref, query, rlen, qlen, dir_format=fmt,
                                    interleave=il, **kw), 20)
            res[name]["plain_ms"] = plain_ms
            log(f"  {name} at B={B_MAIN} T={T_MAIN}: kernel "
                f"{res[name]['ms']:.4f} ms, plain {plain_ms:.4f} ms")

    # Plane 2 timed at the probe's shape, B = 2048, T = 376.
    refs, queries = (torch.from_numpy(x[0]).to(dev) for x in
                     related_batches(1, 2048, 376))
    lens = torch.full((2048,), 376, dtype=torch.int32, device=dev)
    kw = SCORING
    e = max_abs_err(plane2(refs, queries, lens, lens, **kw),
                    plane2_torch(refs, queries, lens, lens, **kw))
    res["plane2"]["max_abs_err"] = max(res["plane2"]["max_abs_err"], e)
    if e:
        raise AssertionError("plane2 mismatch at B=2048 T=376")
    res["plane2"]["ms"] = median_ms(
        lambda: plane2(refs, queries, lens, lens, **kw), 10)
    res["plane2"]["plain_ms"] = median_ms(
        lambda: plane2_torch(refs, queries, lens, lens, **kw), 3)
    log(f"  plane2 at B=2048 T=376: kernel {res['plane2']['ms']:.4f} ms, "
        f"plain {res['plane2']['plain_ms']:.4f} ms")

    # The scans at B = 2048, TJP = 384, 16 chained scans a row.
    x = torch.from_numpy(scanshift_probe.probe_inputs(1, 2048, 376)[0][0]
                         ).to(dev)
    want = scanshift_torch(x)
    plain_ms = median_ms(lambda: scanshift_torch(x), 5)
    for name, fn in scans.items():
        e = max_abs_err({0: fn(x)}, {0: want})
        if e:
            raise AssertionError(f"{name} mismatch at TJP=384")
        res[name] = dict(max_abs_err=e, ms=median_ms(lambda: fn(x), 20),
                         plain_ms=plain_ms)
        log(f"  {name} at B=2048 TJP=384: kernel {res[name]['ms']:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
    return res, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from darwin_tpu_torch import _build
    from darwin_tpu_torch.ops.dp import align_tiles
    from darwin_tpu_torch.ops.tile_fetch import fetch_tiles
    from darwin_tpu_torch.ops.traceback import traceback

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[1/5] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = _build.build()
    _build.lib()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s -> {_build.LIB}")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  " + line.strip())

    log("[2/5] kernels against their plain versions (tolerance 0)")
    kres = phase_kernels(dev)
    log("[3/5] fixtures against the reference binary's out.darwin")
    phase_fixtures(dev)
    log("[4/5] E.coli-shaped slice through darwin_tpu_torch.cli")
    counters = (align_tiles, traceback, fetch_tiles)
    launches = phase_ecoli(counters)
    log("[5/5] kernel lab (darwin_tpu_torch.lab), then each lab kernel "
        "against its plain version")
    t0 = time.perf_counter()
    lres, llaunches = phase_lab(dev)
    log(f"  phase 5 took {time.perf_counter() - t0:.1f} s")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    meta = {
        "dp": ("align_tiles", "darwin_tpu_torch/csrc/dp.cu",
               "darwin_tpu/ops/pallas_dp.py:523"),
        "traceback": ("traceback", "darwin_tpu_torch/csrc/traceback.cu",
                      "darwin_tpu/ops/traceback.py:156"),
        "fetch": ("fetch_tiles", "darwin_tpu_torch/csrc/tile_fetch.cu",
                  "darwin_tpu/ops/tile_fetch.py:161"),
    }
    kernels = [dict(name=fn, route="cuda", source=src, replaces=rep,
                    launches=launches[fn], **kres[k])
               for k, (fn, src, rep) in meta.items()]
    lab_meta = {name: ("darwin_tpu_torch/csrc/dp.cu", rep)
                for name, rep in DP_VARIANTS.values()
                if name != "align_tiles"}
    lab_meta.update(LAB_KERNELS)
    kernels += [dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=llaunches[name], **lres[name])
                for name, (src, rep) in lab_meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
