#!/usr/bin/env python3
"""Drive the PyTorch port (darwin_tpu_torch) on one CUDA card and check
every part of its main path.

    python3 chip_smoke.py

Phases; any failure ends the run with a nonzero exit code:

1. device: the card's name and power limit; the kernels are built from
   darwin_tpu_torch/csrc (nvcc, sm_90a), the normal library and the
   checked one (-DDTT_CHECKED) at once, the build time and the normal
   library's registers a kernel printed;
2. kernels: each CUDA kernel of the main paths against its plain
   PyTorch version on the card, bit-exact (every output is an integer):
   the DP, the three walkers (dir bytes, packed and packed6 words) at
   B = 512 and T = 320, 64, 376 under three scoring sets, the three
   walkers also on walk_cases' adversarial tiles (packed by the plain
   packers for the word walkers), the span fetch as a pair
   (fetch_tile_pair, the engine's form) and as one set on two banks,
   the score-only SW at B = 64 on 200-3000 base pairs and at its
   tiling's edges (sw_edge_shapes); with kernel and plain times (CUDA
   events, median) at B = 512, T = 320, ET = 200, and for SW at B = 64
   on 3 kb pairs, each beside its bound (bytes over the HBM rate or
   int32 operations over the int32 rate, from this run's inputs) and,
   for the span fetch, the time of one advanced-index gather of the
   banks (never taken on the path); the main path's kernels, SW, the
   word walkers and the gathers also as device time (device_ms: a CUDA
   graph of 50 launches, replayed, over 50), SW also on 8 times the
   pairs; the three walkers at early terminates past their old caps
   (LARGE_ET: 30000, packed6 16000) on walk_cases and DP tiles, T =
   320, B = 16; the D-SOFT kernel (csrc/dsoft.cu) under each index mode
   on the E.coli slice's 920 read-strands and on dsoft_cases
   (tests/test_dsoft_device.py's cases, made from the port's golden
   table, and dsoft_budget_cases, reads on both sides of the kernel's
   shared-memory tuple budget; where no read overflowed, also equal to
   dsoft_scalar), timed at the E.coli shape under the default index
   mode (with the read-strands' tuple counts: max, p99, mean) and at ten
   times its read-strands (R = 9200);
3. fixtures: darwin_tpu_torch.pipeline.run_pipeline on every
   tests/data fixture that has an out.darwin (the reference binary's
   output), under the device engine, the host-stepped engine and the
   device engine with the device D-SOFT (dsoft="device"); record sets
   must be equal;
4. the E.coli-shaped slice: a 4.6 Mb synthetic genome, 460 x 10 kb
   reads at 12% error (seed 42), self-overlap, default params, 512
   slots, made once; its sha256 must equal
   tests/data/ecoli_shape/dataset.sha256.  Five runs, each with the
   launch counters zeroed just before it and read just after: the CLI
   (device engine, dir bytes), the device engine with tb_format
   "packed" and "packed6" through pipeline.run_device_merged, the CLI
   with --engine host --paf-out, and the CLI with --dsoft device.
   Every run's merged records must equal
   tests/data/ecoli_shape/jax_cpu.darwin (darwin_tpu's own output on a
   CPU), the host stages must have run the port's native library
   (host_native), not their NumPy fallbacks, every kernel a run uses
   must have launched in it, the device engine's runs must launch the
   span fetch once an engine iteration, and the --dsoft device run's
   dsoft_overflow_reads must be the plain version's count (phase 2).
   Then each run's seed_s, and the records' sensitivity and specificity
   (eval/sensitivity.py, the read names' coordinates as the truth);
5. the kernel lab (darwin_tpu_torch.lab): with the counters zeroed
   again, its geometry sweep (every dir format and interleave 1, 2, 4,
   each output checked bit-exact against the plain version), the `ilp`
   experiment in every format, the full-step experiments (`byte_full`
   and the word walkers' `packed`, `packed6`, `p6compact`, `tbunroll`)
   at the tool's shape, the
   plane-2 probe's emit and gather (each gather mode beside its bound)
   at B = 2048, T = 376 and the scan probe at
   TJP = 384 with its cross-check; every DP variant, both word walkers,
   the plane-2 kernel and both scan lowerings must have launched.  Then
   each lab kernel against its plain version: the DP variants and
   plane 2 at TILES x SCORINGS (B = 512, tiles with rlen < T), plane 2
   also at B = 2048, T = 376, the scans at B = 2048, TJP = 384 and at
   SCAN_WIDTHS (B = SCAN_EDGE_B); with
   kernel and plain times (CUDA events, median) and bounds: the DP
   variants at B = 512, T = 320, plane 2 and the scans at B = 2048, the
   scans beside one torch.cummax;
6. the score evaluator: two read sets of 40 x 4 kb reads from a 100 kb
   genome (seed 7; darwin_tpu_torch.eval.datagen.two_readsets)
   overlapped by the port's CLI, then darwin_tpu_torch.eval.score_eval's
   main on the records, with the SW counter zeroed before and nonzero
   after; the exact scores of every theoretical pair, both strands, from
   the SW kernel must equal the plain version's;
7. the checked library, whose every global access traps out of its
   allocation: an out-of-bounds launch (checked_trap) must end a child
   process on it in a trap's launch failure (trapped); then phase 2's
   inputs (checked_digests: the DP in
   three formats and plane 2 at every TILES entry, the three walkers on
   the DP's output, on walk_cases and at LARGE_ET, the fetch at both
   bank ends, SW at B = 64 and at its tiling's edges, both scan
   lowerings at B = 2048, C = 384 and at SCAN_WIDTHS, the D-SOFT kernel
   on dsoft_cases and the E.coli read-strands, once and ten times over,
   the table-sharded kernels on SHARDED_CASES and the E.coli
   read-strands, shard_scan at each L % 4 and shard_count on
   SHARD_COUNT_CASES) run in another child
   (``--checked``), which must exit 0 with every output equal to the
   normal library's;
8. the golden soak: tests/test_fuzz_pipeline.py's pinned instances
   (tools/torch_fuzz_soak.py's copies of its generators) through the
   port's pipeline on the card, each record set equal to the golden
   spec's (golden/, computed in spawned processes from phase 3 on) and
   each instance's device D-SOFT calls equal to the host D-SOFT's;
9. the mesh and multi-host layer, every mesh entry cuda:0 (phase_mesh):
   with the counters zeroed, pipeline.collect_calls_table_sharded on the
   E.coli slice's merged bank at mesh sizes 1 and MESH under each
   exchange (budgets derived), equal to the native collect_calls (the
   table-sharded kernels' launches on the kernels line come from these
   runs); the two kernels (csrc/dsoft_sharded.cu) against their plain
   versions on every shard, bit-exact, on the E.coli read-strands over
   MESH and on SHARDED_CASES over SHARDED_P, each index mode and
   exchange, the whole function also against dsoft_table_sharded_torch
   and, where no read overflowed, the golden dsoft_scalar; shard_scan
   alone on the first case's reads padded to each L % 4; shard_count
   alone on SHARD_COUNT_CASES (reads at each of its forms' edges and
   past its shared-memory budget), failing unless each of its three
   forms (registers, shared memory, device memory) took reads; each
   kernel timed on shard 0's E.coli inputs beside its plain version and
   bound; the collector's wall and dsoft_table_sharded's steps (scan,
   tuples, exchange, group, count: CUDA events at each step's end) under
   each exchange;
   sharded_dsoft over MESH against one dsoft_device_batch call;
   ShardedTileAligner against TorchTileAligner at B = 512, T = 320;
   ShardedGactEngine over MESH on the E.coli slice (its records phase
   4's); the CLI with --mesh 1 (phase 4's --merged-out), --mesh 2 (must
   fail: one card), --distributed as two gloo processes on the small
   fixture and on the E.coli slice with --seed-table (rank 0 builds it;
   both ranks' --merged-out equal to each other, to their darwin.<rank>.out
   files' union and to the one-process run's); entry.dryrun_multichip
   over MESH entries;
10. drain and bench: the engine's two-tier drain must stay off on the
   E.coli slice (phase 4's device engine runs: no re-dispatch, the
   gate's (tail, total) printed); tools/torch_drain_prof.py's skewed
   workload (4.6 Mb genome, 1024 calls, every 16th on a 30 kb read, 512
   slots, T = 320) with the counters zeroed under auto, where the gate
   must engage and the engine re-dispatch, the kernels of its path
   launched (the span fetch once an iteration of both tiers); then drain
   off, auto and always in turns, DRAIN_REPS warm runs each (align_s
   medians, iterations, active slot-iterations), one record set.  Then one
   batch of darwin_tpu_torch.bench's step at B = 2048, T = 376 against
   the plain versions' sink, and the bench at full size in a child
   process, which must exit 0 with value > 0; its JSON line is printed
   and the launches it reports count on the kernels line;
11. scale and serving (tools/torch_scale_test.py,
   torch_resident_serve.py, torch_bigcoord_dryrun.py): the guided
   multi-chromosome dataset of tests/data/guided_shape (4 pieces of a
   4.6 Mb genome, 4600 x 10 kb reads at 12% error, seed 42:
   GUIDED_SHAPE_FLAGS) rebuilt by torch_scale_test's generator, its two
   digests checked, then run through the device engine (bytes walker)
   with the host D-SOFT and with the device D-SOFT, each record set
   equal to jax_cpu.darwin (darwin_tpu's own CPU output), with its
   sensitivity, specificity and reads/s; resident serving on the E.coli
   slice (seed table, banks and engine built once, RESIDENT_REPS batches
   after a first), every batch's records phase 4's; the bigcoord run
   just past 2^31 bases (BIGCOORD_FLAGS: 40 pieces, every piece but the
   last N), where the span fetch (on the genome bank past 2^31 bytes)
   and the D-SOFT kernel (on the reads' strands, the table's positions
   past 2^31) are held to their plain versions, then every read must
   re-map through the device engine with the host and with the device
   D-SOFT; peak host RSS and device memory.  Every run is counted, the
   kernels of its path must launch, and its launches count on the
   kernels line.

The last three lines are a JSON summary of the kernels, nvidia-smi's
name and power limit, and {"ok": true, "device": {...}}.  Without a
CUDA device it prints no result and exits 1.  It imports no JAX.

    python3 chip_smoke.py --root TREE

instead builds and imports TREE's darwin_tpu_torch (an older commit
unpacked beside the repo, or the repo itself), prints its normal
library's registers a kernel (when it builds it), and only times its
byte walker, span fetch, word walkers, SW, D-SOFT (R = 920 and 9200),
scan lowerings and table-sharded kernels (shard_scan at R = 920 and
9200, shard_count; the collector's wall and the kernels' part of it)
(phase_ab), so that two trees run in turns compare on one card in one
sitting.

    python3 chip_smoke.py --checked [--small | --trap] [--budgets B]

runs checked_digests on the checked library (phase 7's child; --small:
one small input a kernel; --budgets: the E.coli slice's budgets at mesh
size MESH as a JSON [tup_max, cand_max, a2a_cap], so that the child
derives none) and prints the digests as its last line, or (--trap)
checked_trap, an out-of-bounds launch that must end it.

    python3 chip_smoke.py --index-modes

only times the E.coli slice's D-SOFT on its merged bank, the native host
collect_calls beside collect_calls_device cold and warm under each index
mode, with each mode's kernel time (seed_times), and prints them as JSON.
"""

from __future__ import annotations

import concurrent.futures
import functools
import hashlib
import json
import multiprocessing
import os
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
SW_B, SW_LEN = 64, 3000
# A kernel's bound is the larger of the bytes it must move over the HBM
# rate and its int32 operations over the card's int32 rate (NVIDIA
# H100 SXM: 3.35 TB/s; 132 SMs x 64 INT32 lanes x 1.98 GHz, half the
# FP32 lanes behind the 67 TFLOP/s FP32 peak).  Operations a unit of
# work, as the kernels' source notes count them: a DP cell 15 (M: add,
# max; I and D: two adds, a max, a >= each; H: a max of three and its
# tie order, two compares; the direction byte, three); an SW cell 10;
# a walker step 8; a scan element 2 (add, max); a D-SOFT tuple 10 past
# its sort (its bin key 2, the segmented count 4: a bin compare, the
# mpos gap, a min, an add; the crossing test 2; the compaction 2).
HBM_BYTES_S = 3.35e12
# device_ms: a CUDA graph of this many launches, replayed, over its count.
GRAPH_LAUNCHES = 50
INT32_OPS_S = 132 * 64 * 1.98e9
DP_OPS_CELL, SW_OPS_CELL, WALK_OPS_STEP, SCAN_OPS = 15, 10, 8, 2
TUPLE_OPS = 10


def _dp_variant(fmt: str, il: int) -> str:
    """JSON name of one DP variant."""
    if il == 1:
        return "align_tiles" if fmt == "bytes" else f"align_tiles[{fmt}]"
    return f"align_tiles[{fmt},il={il}]"


# The DP kernel's variants, by (dir_format, interleave).
DP_VARIANTS = {(fmt, il): _dp_variant(fmt, il)
               for fmt in ("bytes", "packed", "packed6") for il in (1, 2, 4)}
# Every kernel of the kernels line: (its source, the TPU kernel or JAX
# function it replaces as "path:line", and what that line holds:
# "pallas_call" for a Pallas kernel, else the name of the function
# defined there).  The main paths' kernels come first.
DP_SRC = "darwin_tpu_torch/csrc/dp.cu"
WALK_SRC = "darwin_tpu_torch/csrc/traceback_words.cu"
SHARDED_SRC = "darwin_tpu_torch/csrc/dsoft_sharded.cu"
SHARDED_REPLACES = "darwin_tpu/dsoft/sharded_table.py:265"
KERNELS = {
    "align_tiles": (DP_SRC, "darwin_tpu/ops/pallas_dp.py:523",
                    "pallas_call"),
    "traceback": ("darwin_tpu_torch/csrc/traceback.cu",
                  "darwin_tpu/ops/traceback.py:29", "traceback_jax"),
    "traceback_packed": (WALK_SRC, "darwin_tpu/ops/traceback.py:370",
                         "traceback_packed_jax"),
    "traceback_packed6": (WALK_SRC, "darwin_tpu/ops/traceback.py:158",
                          "traceback_packed6_jax"),
    "fetch_tiles": ("darwin_tpu_torch/csrc/tile_fetch.cu",
                    "darwin_tpu/ops/tile_fetch.py:161", "pallas_call"),
    "dsoft_device": ("darwin_tpu_torch/csrc/dsoft.cu",
                     "darwin_tpu/dsoft/device.py:341", "dsoft_device_batch"),
    "local_score_batch": ("darwin_tpu_torch/csrc/swscore.cu",
                          "darwin_tpu/ops/swscore.py:33",
                          "local_score_batch"),
    **{name: (DP_SRC, "darwin_tpu/ops/pallas_dp.py:"
              + ("523" if il == 1 else "493"), "pallas_call")
       for (fmt, il), name in DP_VARIANTS.items() if name != "align_tiles"},
    "plane2": (DP_SRC, "tools/plane2_probe.py:209", "pallas_call"),
    "scanshift_shfl": ("darwin_tpu_torch/csrc/scanshift.cu",
                       "tools/scanshift_probe.py:97", "pallas_call"),
    "scanshift_smem": ("darwin_tpu_torch/csrc/scanshift.cu",
                       "tools/scanshift_probe.py:97", "pallas_call"),
    # The table-sharded D-SOFT's two per-read steps: together they replace
    # one XLA function, the per-device body of dsoft_table_sharded_fn, so
    # they share its line (phase 9).
    "dsoft_shard_scan": (SHARDED_SRC, SHARDED_REPLACES,
                         "_dsoft_table_sharded_local"),
    "dsoft_shard_count": (SHARDED_SRC, SHARDED_REPLACES,
                          "_dsoft_table_sharded_local"),
}
# The main path's kernels, whose device time (device_ms) is taken too;
# the span fetch also in its one-set form, ONE_SET.
ONE_SET = "fetch_tiles[one set]"
DEVICE_TIMED = ("align_tiles", "traceback", "fetch_tiles", ONE_SET,
                "traceback_packed", "traceback_packed6", "local_score_batch",
                "dsoft_device")
# The keys of each entry of the kernels line.
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}
# The kernels each phase 4 run must launch.
ECOLI_RUNS = {
    "cli bytes": ("align_tiles", "fetch_tiles", "traceback"),
    "packed": ("align_tiles", "fetch_tiles", "traceback_packed"),
    "packed6": ("align_tiles", "fetch_tiles", "traceback_packed6"),
    "cli host --paf-out": ("align_tiles", "traceback_packed6"),
    "cli bytes --dsoft device": ("dsoft_device", "align_tiles",
                                 "fetch_tiles", "traceback"),
}
# The E.coli-shaped slice's reads (phase 4) and the device D-SOFT's
# budgets there (collect_calls_device's defaults).
ECOLI_READS = 460
TUP_MAX, CAND_MAX = 8192, 512
# csrc/dsoft.cu's kSmemTuples: a read-strand whose min(total, tup_max)
# exceeds it leaves the shared-memory path for the large one
# (tests/test_torch_dsoft_device.py holds the two equal).
DSOFT_SMEM_TUPLES = 1024
# The num_seeds cap of dsoft_budget_reads' cases: above any of their
# reads' passing minimizers.
BUDGET_CAP = 5000
# Their tuple budgets: the default (the reads past the shared-memory
# budget take the large path, its arrays in shared memory), one between
# the reads' totals (the largest overflows from the large path), the
# shared-memory budget itself (no large path; the reads past it
# overflow) and 32768 (the large path's arrays in device memory).
BUDGET_TUP_MAX = (TUP_MAX, 1200, DSOFT_SMEM_TUPLES, 32768)
# The scan probe's widths checked on the card: each side of one, two and
# 12 columns a lane and of 32, at a batch that is no multiple of the
# kernel's 8 rows a block.
SCAN_WIDTHS = (1, 31, 32, 33, 64, 65, 383, 384, 1023, 1024)
SCAN_EDGE_B = 37
# Early terminates past every walker's old shared-buffer cap, at T = 320
# and B = 16 (bytes and packed; packed6, whose stream is twice as wide),
# and at the edge of the walkers' op buffer (2048 slots a stretch): the
# last stream that fits it and the first that takes two stretches.
LARGE_ET = {"bytes": 30000, "packed": 30000, "packed6": 16000}
EDGE_ET = {"bytes": (1024, 1025), "packed": (1024, 1025),
           "packed6": (512, 513)}
# Phase 9's mesh on the one card: MESH entries of cuda:0, and
# SHARDED_P for tests/test_sharded_table.py's cases, whose shard bounds,
# budgets and overflow flags depend on the shard count (8, as darwin_tpu's
# tests run them on 8 virtual devices).
MESH, SHARDED_P = 4, 8
# The table-sharded D-SOFT's cases (tests/test_sharded_table.py's
# instances, sharded_fixture): name -> (sharded_fixture's arguments,
# threshold, num_seeds_cap, max_candidates, tup_max, cand_max, a2a_cap of
# the all-to-all, whether a read overflows under the all-to-all, under
# the all-gather).  tests/test_torch_sharded_table.py holds the port to
# darwin_tpu on the same cases.
SHARDED_CASES = {
    "seed 17": (dict(seed=17), 15, 800, 10**6, 4096, 128, 2048, False,
                False),
    "seed 23": (dict(seed=23), 10, 800, 10**6, 4096, 128, 2048, False,
                False),
    "repetitive": (dict(seed=31, repetitive=True, err=0.05), 12, 800, 10**6,
                   16384, 512, 8192, False, False),
    "caps": (dict(seed=41), 10, 60, 3, 4096, 128, 2048, False, False),
    "tup_max overflows": (dict(seed=47, repetitive=True, err=0.02), 10, 800,
                          10**6, 64, 128, 64, True, True),
    "a2a_cap 8 overflows": (dict(seed=47, repetitive=True, err=0.02), 10,
                            800, 10**6, 16384, 256, 8, True, False),
    "positions past 2^31": (dict(seed=37), 15, 800, 10**6, 4096, 128, 1024,
                            False, False),
    # 20 copies of a 2 kb unit (each minimizer under the table's
    # occurrence cap of 32): reads of thousands of tuples, past
    # shard_count's register budget (its shared-memory form).
    "long repeats": (dict(seed=59, repetitive=True, err=0.02, unit=2000),
                     12, 800, 10**6, 65536, 512, 16384, False, False),
}

# csrc/dsoft_sharded.cu's shard_count budgets (kRegTuples, kSmemTuples): a
# read of up to SHARD_COUNT_REG_TUPLES tuples sorts in registers, one of
# up to SHARD_COUNT_SMEM_TUPLES in dynamic shared memory, a longer one in
# device memory (tests/test_torch_sharded_table.py holds them equal).
SHARD_COUNT_REG_TUPLES, SHARD_COUNT_SMEM_TUPLES = 1024, 22752
# shard_count's synthetic cases (shard_count_case): name -> (seed, the
# tuples of each read, shard_count's keywords).  The reads sit at each
# form's edges and past the shared-memory budget, max_candidates capping
# the longest; the second case caps the candidates below max_candidates
# (overflow flags) and takes bin_size 1, so that hits past 2^31 give bins
# past 2^31 (negative as int32).
SHARD_COUNT_CASES = {
    "form edges": (61, (0, 1, SHARD_COUNT_REG_TUPLES,
                        SHARD_COUNT_REG_TUPLES + 1, 300,
                        SHARD_COUNT_SMEM_TUPLES, SHARD_COUNT_SMEM_TUPLES + 1,
                        0, 40000, 777),
                   dict(k=12, bin_size=64, threshold=40,
                        max_candidates=60, cand_max=512)),
    "caps, bins past 2^31": (67, (5, SHARD_COUNT_REG_TUPLES,
                                  SHARD_COUNT_REG_TUPLES + 1, 4000,
                                  SHARD_COUNT_SMEM_TUPLES + 1),
                             dict(k=14, bin_size=1, threshold=30,
                                  max_candidates=12, cand_max=8)),
}


def log(*a):
    print(*a, flush=True)


def _registers(report: str) -> list:
    """nvcc -Xptxas -v's lines naming a kernel and its registers."""
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "Compiling entry" in ln]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: int, ops: int) -> dict:
    """bound_ms and bound_by of work that moves nbytes and does ops
    int32 operations."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / INT32_OPS_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def sort_count_ops(tuples) -> int:
    """The operations that sorting and counting reads' tuples needs, for
    a read of n tuples in tuples: n * ceil(log2 n) comparisons (a
    comparison sort's least, whatever network the kernel runs) and
    TUPLE_OPS a tuple."""
    return sum(n * max(0, n - 1).bit_length() + TUPLE_OPS * n
               for n in tuples)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dp_bound(ref, query, rlen, qlen, out: dict) -> dict:
    """A DP call's bound: its inputs and outputs once, and the cells
    this batch's lengths need (min(rlen, T) x min(qlen, T) a tile)."""
    T = ref.shape[1]
    cells = int((rlen.clamp(0, T).long() * qlen.clamp(0, T).long()).sum())
    return bound(nbytes(ref, query, rlen, qlen, *out.values()),
                 DP_OPS_CELL * cells)


def walk_bound(args, out) -> dict:
    """A walker call's bound: one direction byte a step of the walks
    this batch takes (the ops it records), its small inputs and its
    outputs."""
    steps = int((out[0] != 0).sum())
    return bound(steps + nbytes(*args[1:], *out), WALK_OPS_STEP * steps)


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


def graph_ms(fn, n: int = GRAPH_LAUNCHES) -> float:
    """Device time of one fn() call: n calls captured in one CUDA graph,
    the graph's replay timed (CUDA events, median of 5) over n, so the
    host's launch path is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = median_ms(graph.replay, 5) / n
    del graph
    return ms


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


WALK_CASES = 32  # lanes of one walk_cases batch


def _plant(d, i: int, j: int, runs) -> None:
    """Set bits of one tile's dir bytes d [T, T+1] so that the walk from
    DP cell (i, j) takes the states of runs ([(state, steps), ...],
    MATCH 3, INSERT 2, DELETE 1; a gap run is never followed by the
    other gap) and then stops on a ZERO op.  Cells outside rows and
    columns 1..T are not planted: there the walk goes on by its own
    rules (row 0 and column 0 read as ZERO)."""
    from darwin_tpu_torch.ops.common import GAP_OPEN_FLAG_D, GAP_OPEN_FLAG_I

    T = d.shape[0]
    states = [s for s, n in runs for _ in range(n)]
    if not states or states[-1] != 3:
        states.append(3)

    def put(i, j, mask, bits):
        if 1 <= i <= T and 1 <= j <= T:
            d[i - 1, j] = (int(d[i - 1, j]) & ~mask) | bits

    put(i, j, 3, states[0])
    for st, nxt in zip(states, states[1:] + [0]):
        if st == 3:  # the entered cell's op bits give the next state
            i, j = i - 1, j - 1
            put(i, j, 3, nxt)
        elif st == 2:  # the current cell's flag: stay in INSERT or MATCH
            put(i, j, GAP_OPEN_FLAG_I, 0 if nxt == 2 else GAP_OPEN_FLAG_I)
            i -= 1
        else:
            put(i, j, GAP_OPEN_FLAG_D, 0 if nxt == 1 else GAP_OPEN_FLAG_D)
            j -= 1


def walk_cases(rng, T: int):
    """WALK_CASES adversarial byte-walker tiles at tile size T, as numpy
    (dirm [B, T, T+1] uint8, ref_len, query_len, first, max_i, max_j):
    random dir bytes with planted walks.  Lanes: an INSERT and a DELETE
    run longer than a 32 x 64 window (40 rows, 72 columns, cut to the
    tile), both in one walk, diagonals onto row 0 and onto column 0,
    INSERT and DELETE runs across row 0 and column 0 (the walk goes on
    reading ZERO bytes until ET), walks that start in a gap state and
    run into the ET cut-off on either axis, starts at (T, T), first
    tiles whose max cell is at (rlen, qlen), rlen = 0, qlen = 0, a
    one-row and a one-column tile, a first tile whose max cell is
    (0, 0), a start past the matrix (clipped into it), and random mixes
    of runs from random starts.  Imports nothing that needs a card."""
    import numpy as np

    M, I, D = 3, 2, 1
    up, left, h = min(T, 40), min(T, 72), max(1, T // 8)
    # (rlen, qlen, first, max_i, max_j, runs or None for the bytes as
    # they are); non-first tiles start at (rlen, qlen).
    cases = [
        (T, T, False, 0, 0, [(M, h), (I, up), (M, T)]),
        (T, T, False, 0, 0, [(M, h), (D, left), (M, T)]),
        (T, T, True, T, T, [(M, 3), (I, 5), (M, 4), (D, 9), (M, 2),
                            (I, up), (M, 6), (D, left), (M, T)]),
        (max(1, T // 2), T, False, 0, 0, [(M, T)]),
        (T, max(1, T // 2), False, 0, 0, [(M, T)]),
        (min(T, 20), T, False, 0, 0, [(M, 2), (I, 2 * T)]),
        (T, min(T, 20), False, 0, 0, [(M, 2), (D, 2 * T)]),
        (T, T, False, 0, 0, [(I, T), (M, T)]),
        (T, T, False, 0, 0, [(D, T), (M, T)]),
        (T, T, True, T, T, [(M, 2 * T)]),
        (max(1, T - 3), max(1, T - 7), True, max(1, T - 3), max(1, T - 7),
         [(M, h), (D, 2), (M, T)]),
        (0, T, False, 0, 0, None),
        (T, 0, False, 0, 0, None),
        (1, T, False, 0, 0, [(D, T // 2), (M, 1)]),
        (T, 1, False, 0, 0, [(I, T // 2), (M, 1)]),
        (T, T, True, 0, 0, None),
        (T + 3, T + 5, False, 0, 0, None),
    ]
    while len(cases) < WALK_CASES:
        rlen, qlen = (int(x) for x in rng.integers(1, T + 1, size=2))
        first = bool(rng.random() < 0.5)
        runs = []
        while sum(n for _, n in runs) < 2 * T:
            runs += [(M, int(rng.integers(1, 30))),
                     (int(rng.integers(1, 3)), int(rng.integers(1, 80)))]
        cases.append((rlen, qlen, first, int(rng.integers(0, rlen + 1)),
                      int(rng.integers(0, qlen + 1)), runs))
    dirm = rng.integers(0, 32, size=(WALK_CASES, T, T + 1), dtype=np.uint8)
    for b, (rlen, qlen, first, mi, mj, runs) in enumerate(cases):
        if runs is not None:
            _plant(dirm[b], mi if first else rlen, mj if first else qlen,
                   runs)
    cols = list(zip(*[c[:5] for c in cases]))
    return (dirm, *(np.array(x, dtype=np.int32) for x in cols[:2]),
            np.array(cols[2], dtype=bool),
            *(np.array(x, dtype=np.int32) for x in cols[3:]))


def walk_case_batch(rng, T: int, B: int):
    """B lanes of walk_cases: as many batches as B needs, cut to B."""
    import numpy as np

    parts = [walk_cases(rng, T) for _ in range(-(-B // WALK_CASES))]
    return tuple(np.concatenate(x)[:B] for x in zip(*parts))


# The walkers' JSON names by dir format.
WALKERS = {"bytes": "traceback", "packed": "traceback_packed",
           "packed6": "traceback_packed6"}


def _walker_pairs(fmt: str, ET: int, args):
    """(kernel, plain) closures of one walker on the same inputs."""
    from darwin_tpu_torch.ops import traceback as tb

    kernel = tb.WALKERS[fmt][1]
    plain = {"bytes": tb.traceback_torch,
             "packed": tb.traceback_packed_torch,
             "packed6": tb.traceback_packed6_torch}[fmt]
    return (lambda: kernel(*args, early_terminate=ET),
            lambda: plain(*args, early_terminate=ET))


def sw_pairs(rng, B: int, L: int):
    """[B, L] ref/query of related ACGT (the query a window of the ref
    with 10% of its bases redrawn), lengths 200..L, zero-padded; lanes 0
    and 1 have an empty ref and an empty query."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = np.zeros((B, L), np.uint8)
    query = np.zeros((B, L), np.uint8)
    rlen = rng.integers(200, L + 1, size=B).astype(np.int32)
    qlen = rng.integers(200, L + 1, size=B).astype(np.int32)
    rlen[0] = qlen[1] = 0
    for b in range(B):
        src = acgt[rng.integers(0, 4, size=2 * L)]
        q = src[rng.integers(0, L // 2):].copy()
        mut = rng.random(len(q)) < 0.1
        q[mut] = acgt[rng.integers(0, 4, size=int(mut.sum()))]
        ref[b, :rlen[b]] = src[:rlen[b]]
        query[b, :qlen[b]] = q[:qlen[b]]
    return ref, query, rlen, qlen


def sw_edge_shapes() -> list:
    """(LR, LQ) at the SW kernel's tiling edges (W = swscore.WARPS warps
    a block, C = 2..16 columns a lane): the query one below, at and one
    above W * 32 * 2 columns (the least C's pass) and W * 32 * 16 (the
    most C's: above it a second pass), two and three passes under short
    and long refs (the pass period set by the warps' lag or by LR),
    refs shorter than W rows, and one-row and one-column pairs."""
    from darwin_tpu_torch.ops.swscore import SW_STRIPS, WARPS

    low, one = 32 * SW_STRIPS[0] * WARPS, 32 * SW_STRIPS[-1] * WARPS
    return [(1, 1), (1, 33), (WARPS - 1, low - 1), (WARPS - 1, low),
            (40, low + 1), (3, one - 1), (40, one), (WARPS - 1, one + 1),
            (300, one + 1), (2, 2 * one + 3), (33, 1)]


def sw_edge_pairs(rng, B: int, LR: int, LQ: int):
    """[B, LR] / [B, LQ] pairs as sw_pairs makes them, lengths random in
    1..L; lane 0 has an empty ref, lane 1 an empty query, lane 2 (and
    lane 0 of a batch of one) both at full length."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = np.zeros((B, LR), np.uint8)
    query = np.zeros((B, LQ), np.uint8)
    rlen = rng.integers(1, LR + 1, size=B).astype(np.int32)
    qlen = rng.integers(1, LQ + 1, size=B).astype(np.int32)
    if B >= 3:
        rlen[0] = qlen[1] = 0
        rlen[2], qlen[2] = LR, LQ
    else:
        rlen[0], qlen[0] = LR, LQ
    for b in range(B):
        src = acgt[rng.integers(0, 4, size=LR + LQ)]
        q = src[rng.integers(0, LR + 1):].copy()
        mut = rng.random(len(q)) < 0.1
        q[mut] = acgt[rng.integers(0, 4, size=int(mut.sum()))]
        ref[b, :rlen[b]] = src[:rlen[b]]
        query[b, :qlen[b]] = q[:qlen[b]]
    return ref, query, rlen, qlen


def fetch_banks(rng, dev):
    """The span fetch's two banks on dev: a genome-sized bank of 4.6 M
    bytes whose storage ends at its last byte, and a read-sized bank of
    9.2 M + 1 bytes padded as device_banks pads it."""
    import numpy as np
    import torch

    from darwin_tpu_torch.ops.common import PAD_QUERY

    acgt = np.frombuffer(b"ACGT", np.uint8)
    gbank = torch.from_numpy(acgt[rng.integers(0, 4, size=4_600_000)])
    nq = 9_200_001
    q = np.full(-(-nq // 16) * 16, PAD_QUERY, dtype=np.uint8)
    q[:nq - 1] = acgt[rng.integers(0, 4, size=nq - 1)]
    return gbank.to(dev), torch.from_numpy(q).to(dev)[:nq]


def fetch_spans(rng, n: int, T: int, dev):
    """B_MAIN (start, length) spans of a bank of n bytes: lengths 0..T,
    starts anywhere from T before the bank to T past it, and four lanes
    far outside it or across its ends."""
    import numpy as np
    import torch

    start = rng.integers(-T, n + T, size=B_MAIN)
    start[:4] = [-10**9, 10**12, n - 5, -3]
    length = rng.integers(0, T + 1, size=B_MAIN).astype(np.int32)
    return torch.from_numpy(start).to(dev), torch.from_numpy(length).to(dev)


def fetch_bound(sets, back, outs) -> dict:
    """A fetch call's bound: the bank bytes its spans read, its starts,
    lengths and backward flags, and its [B, T] outputs."""
    T = outs[0].shape[1]
    used = sum(int(length.clamp(0, T).sum()) for _, _, length, _ in sets)
    return bound(used + nbytes(back, *outs, *(x for _, start, length, _ in
                                               sets for x in (start,
                                                              length))), 0)


def gather_yardstick(sets, back, T: int, want):
    """One PyTorch call computing the fetch of sets [(bank, start,
    length, pad), ...]: an advanced-index gather of the banks and their
    pad bytes concatenated, its [len(sets), B, T] index built
    beforehand.  Checked against want (the kernel's outputs); returns
    the call."""
    import torch

    k = torch.arange(T, device=back.device)[None, :]
    pad_at = sum(bank.shape[0] for bank, *_ in sets)
    idxs, off = [], 0
    for m, (bank, start, length, _) in enumerate(sets):
        s0, L = start[:, None], length.long()[:, None]
        idx = torch.where(back[:, None], s0 + L - 1 - k, s0 + k)
        idx = idx.clamp(0, bank.shape[0] - 1) + off
        idxs.append(torch.where(k < L, idx, pad_at + m))
        off += bank.shape[0]
    pads = torch.tensor([pad for *_, pad in sets], dtype=torch.uint8,
                        device=back.device)
    cat = torch.cat([bank for bank, *_ in sets] + [pads])
    idx = torch.stack(idxs)
    if not torch.equal(cat[idx], torch.stack(list(want))):
        raise AssertionError("the gather yardstick differs")
    return lambda: cat[idx]


def large_et_walks(dev):
    """[(name, fmt, walker args, ET)]: the three walkers at LARGE_ET on B
    = 16 walk_cases tiles (gap runs past row 0 and column 0 go on to ET
    steps) and on the DP's output of 16 related tiles, T = 320, then at
    EDGE_ET on the walk_cases tiles."""
    import numpy as np
    import torch

    from darwin_tpu_torch.ops.dp import PACKERS, align_tiles

    rng = np.random.default_rng(8)
    dirm, *rest = (torch.from_numpy(x).to(dev)
                   for x in walk_case_batch(rng, T_MAIN, 16))
    ref, query, rlen, qlen = (torch.from_numpy(x).to(dev)
                              for x in related_tiles(rng, 16, T_MAIN))
    first = torch.from_numpy(rng.random(16) < 0.5).to(dev)
    cases = []
    edges = []
    for fmt, ET in LARGE_ET.items():
        packer = PACKERS[fmt]
        tiles = (dirm if packer is None else packer(dirm), *rest)
        cases.append((f"{WALKERS[fmt]} ET={ET} walk_cases", fmt, tiles, ET))
        out = align_tiles(ref, query, rlen, qlen, dir_format=fmt, match=1,
                          mismatch=-1, gap_open=-1, gap_extend=-1)
        cases.append((f"{WALKERS[fmt]} ET={ET} dp",
                      fmt, (out["dir" if fmt == "bytes" else "dir_words"],
                            rlen, qlen, first, out["max_i"], out["max_j"]),
                      ET))
        edges += [(f"{WALKERS[fmt]} ET={et} walk_cases", fmt, tiles, et)
                  for et in EDGE_ET[fmt]]
    return cases + edges


def dsoft_fixture(seed, n_reads=10, ref_len=30000, err=0.12, n_frac=0.0):
    """tests/test_dsoft_device.py's instances on the port's golden table:
    (GoldenSeedTable of a random 30 kb reference, k 12, w 4, bin 64;
    reads of 400-2500 bases from it at err substitutions)."""
    import numpy as np

    from darwin_tpu_torch.golden.dsoft import GoldenSeedTable

    alpha = np.frombuffer(b"ACGTN", dtype=np.uint8)
    rng = np.random.default_rng(seed)
    p = [(1 - n_frac) / 4] * 4 + [n_frac]
    ref = rng.choice(alpha, size=ref_len, p=p).astype(np.uint8)
    gt = GoldenSeedTable(ref, 12, 32, 64, 4)
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, max(1, ref_len - 3000)))
        r = ref[s:s + int(rng.integers(400, 2500))].copy()
        mut = rng.random(len(r)) < err
        r[mut] = rng.choice(alpha[:4], size=int(mut.sum()))
        reads.append(r)
    return gt, reads


def dsoft_cases() -> list:
    """The D-SOFT kernel's small cases, tests/test_dsoft_device.py's:
    [(name, GoldenSeedTable, reads, {threshold, num_seeds_cap,
    max_candidates, tup_max, cand_max})].  Three seeds and thresholds;
    N bases with a num_seeds cap of 40; max_candidates 2; tup_max 8
    (overflow raised); cand_max 1; empty and 4-base reads; a table past
    2^31; tup_max 32768 (every read within the shared-memory budget);
    then dsoft_budget_cases, whose tup_max 32768 runs the large path
    from device memory.  Imports nothing that needs a card."""
    import numpy as np

    def kw(threshold=18, cap=800, cand=10**6, tup_max=TUP_MAX, cand_max=256):
        return dict(threshold=threshold, num_seeds_cap=cap,
                    max_candidates=cand, tup_max=tup_max, cand_max=cand_max)

    cases = [(f"seed {s} threshold {t}", *dsoft_fixture(s), kw(t))
             for s, t in ((3, 18), (7, 12), (11, 21))]
    cases += [
        ("N bases, num_seeds 40", *dsoft_fixture(19, n_frac=0.03),
         kw(15, cap=40)),
        ("max_candidates 2", *dsoft_fixture(23), kw(12, cand=2)),
        ("tup_max 8", *dsoft_fixture(5, n_reads=4), kw(12, tup_max=8)),
        ("cand_max 1", *dsoft_fixture(29, err=0.02), kw(12, cand_max=1)),
        ("tup_max 32768", *dsoft_fixture(3), kw(tup_max=32768)),
    ]
    gt, _ = dsoft_fixture(31, n_reads=1)
    cases.append(("empty and short reads", gt,
                  [np.frombuffer(b"ACGT", np.uint8).copy(),
                   np.frombuffer(b"A" * 40, np.uint8).copy(),
                   np.zeros(0, np.uint8)], kw()))
    gt, reads = dsoft_fixture(13)
    shift = np.uint64(2_600_000_000)
    gt.pos_table = (gt.pos_table.astype(np.uint64) + shift).astype(np.uint32)
    gt.ref_size += int(shift)
    cases.append(("positions past 2^31", gt, reads, kw()))
    return cases + dsoft_budget_cases()


def dsoft_budget_cases() -> list:
    """dsoft_cases' entries on dsoft_budget_reads, one a BUDGET_TUP_MAX
    (threshold 18, cand_max 256)."""
    gt, reads = dsoft_budget_reads()
    return [(f"budget edge, tup_max {t}", gt, list(reads),
             dict(threshold=18, num_seeds_cap=BUDGET_CAP,
                  max_candidates=10**6, tup_max=t, cand_max=256))
            for t in BUDGET_TUP_MAX]


@functools.lru_cache(maxsize=1)
def dsoft_budget_reads() -> tuple:
    """(GoldenSeedTable, reads) for one batch that straddles the
    kernel's shared-memory tuple budget (DSOFT_SMEM_TUPLES): a 300-base
    read, then prefixes of one 8 kb read (1% substitutions) of a random
    30 kb reference (dsoft_fixture's table) whose tuple totals under a
    num_seeds cap of BUDGET_CAP are the budget less one, the budget, the
    least above it, and about 1.6 times it (the plain version's steps on
    the CPU pick the lengths).  Under tup_max 1200 the last read
    overflows from the large path, under tup_max = the budget the last
    two from the shared-memory one."""
    import numpy as np
    import torch

    from darwin_tpu_torch.golden.dsoft import GoldenSeedTable

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(37)
    ref = acgt[rng.integers(0, 4, size=30000)]
    gt = GoldenSeedTable(ref, 12, 32, 64, 4)
    s = int(rng.integers(0, 30000 - 8000))
    full = ref[s:s + 8000].copy()
    mut = rng.random(8000) < 0.01
    full[mut] = acgt[rng.integers(0, 4, size=int(mut.sum()))]
    ckw = dict(threshold=18, num_seeds_cap=BUDGET_CAP, max_candidates=10**6,
               tup_max=TUP_MAX, cand_max=256)

    def totals(lengths) -> list:
        args, kw = dsoft_case_args(gt, [full[:n] for n in lengths], ckw,
                                   "searchsorted", torch.device("cpu"))
        return _dsoft_steps(args, kw)["cum"][:, -1].tolist()

    coarse = list(range(64, 8001, 64))
    at_coarse = totals(coarse)
    picks = []
    tb = DSOFT_SMEM_TUPLES
    # (total wanted, whether it must lie above the budget): the nearest
    # total to each, the shortest read at a tie.
    for want, above in ((tb - 1, False), (tb, False), (tb + 1, True),
                        (tb * 8 // 5, True)):
        i = next(i for i, t in enumerate(at_coarse) if t >= want)
        fine = list(range(coarse[max(i - 1, 0)], coarse[i] + 1))
        got = totals(fine)
        picks.append(min(zip(fine, got), key=lambda nt: (
            above and nt[1] <= tb, abs(nt[1] - want), nt[0]))[0])
    return gt, tuple([full[:300].copy()] + [full[:n].copy() for n in picks])


def dsoft_case_args(gt, reads, kw: dict, index: str, dev):
    """(args, kwargs) of dsoft_device_batch on one dsoft_cases entry."""
    import torch

    from darwin_tpu_torch.dsoft.device import device_index, pad_reads
    from darwin_tpu_torch.engine.seqbank import SeqBank

    Q, lens = pad_reads(SeqBank(reads), range(len(reads)))
    th, tpos, steps = device_index(gt.hashes, gt.pos_table, k=gt.k,
                                   index=index, device=dev)
    return ((torch.from_numpy(Q).to(dev), torch.from_numpy(lens).to(dev),
             th, tpos),
            dict(k=gt.k, w=gt.w, bin_size=gt.bin_size,
                 kmer_max_occ=gt.kmer_max_occurence, index=index,
                 tl_steps=steps, **kw))


def scan_edge_input(C: int, dev):
    """[SCAN_EDGE_B, C] int32 values in -1000..999 (seed C) on dev."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(C).integers(
        -1000, 1000, size=(SCAN_EDGE_B, C), dtype=np.int32)).to(dev)


def ecoli_x10(args):
    """dsoft_device_batch's arguments with the read-strands ten times
    over (the E.coli slice's 920 as R = 9200)."""
    return (args[0].repeat(10, 1), args[1].repeat(10), *args[2:])


@functools.lru_cache(maxsize=1)
def ecoli_reads() -> list:
    """The E.coli-shaped dataset (tools/ecoli_shape.py makes the same),
    made once a process; [(name, seq)], not to be changed."""
    import numpy as np

    from darwin_tpu_torch.eval.datagen import sample_reads, synth_genome

    rng = np.random.default_rng(42)
    genome = synth_genome(4_600_000, rng)
    return sample_reads(genome, ECOLI_READS, 10_000, rng, error_rate=0.12,
                        rc_fraction=0.5)


@functools.lru_cache(maxsize=1)
def _ecoli_seed_inputs():
    """The E.coli-shaped slice's default params, genome, seed table,
    merged bank (its read-strands, as the device engine seeds them) and
    that bank padded, made once a process."""
    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.dsoft.device import pad_reads
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.index.genome import Genome
    from darwin_tpu_torch.index.seed_table import SeedTable
    from darwin_tpu_torch.io.fasta import FastaRecord
    from darwin_tpu_torch.pipeline import read_banks

    params = Params()
    recs = [FastaRecord([n], s) for n, s in ecoli_reads()]
    genome = Genome(recs, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size)
    merged = SeqBank.concat(*read_banks(recs))
    return (params, genome, table, merged,
            *pad_reads(merged, range(len(merged.lengths))))


def ecoli_dsoft_inputs(dev, index: str):
    """(args, kwargs) of dsoft_device_batch on the E.coli-shaped slice's
    920 read-strands, default params, collect_calls_device's budgets."""
    import torch

    from darwin_tpu_torch.dsoft.device import device_index

    params, _, table, _, Q, lens = _ecoli_seed_inputs()
    th, tpos, steps = device_index(table.hashes, table.pos, k=table.k,
                                   index=index, device=dev)
    return ((torch.from_numpy(Q).to(dev), torch.from_numpy(lens).to(dev),
             th, tpos),
            dict(k=table.k, w=table.w, bin_size=table.bin_size,
                 kmer_max_occ=table.kmer_max_occurence,
                 num_seeds_cap=params.num_seeds, threshold=params.threshold,
                 max_candidates=params.max_candidates, tup_max=TUP_MAX,
                 cand_max=CAND_MAX, index=index, tl_steps=steps))


def _lookup_sectors(hv, th, index: str, steps: int) -> dict:
    """The 32-byte sectors, by array (int32 entry index // 8), that the
    kernel's lookups of the hashes hv [n] (int64 uint32 values) load:
    csrc/dsoft.cu's lookup, its loads recorded."""
    import torch

    from darwin_tpu_torch.dsoft.device import _u32

    if index == "dense":
        return {"csr": torch.cat([hv, hv + 1]) >> 3}
    if index == "searchsorted":
        hs = _u32(th)
        n = hs.shape[0]
        mids = []
        for right in (False, True):  # lower, then upper bound
            lo, hi = torch.zeros_like(hv), torch.full_like(hv, n)
            while bool((lo < hi).any()):
                act = lo < hi
                mid = (lo + hi) >> 1
                mids.append(mid[act])
                v = hs[mid.clamp(max=n - 1)]
                go = (v <= hv) if right else (v < hv)
                lo = torch.where(act & go, mid + 1, lo)
                hi = torch.where(act & ~go, mid, hi)
        return {"h": torch.cat(mids) >> 3}
    hd, crs, bkt, base, shift = th
    hdv = _u32(hd)
    nd, nb = hd.shape[0], bkt.shape[0] - 1
    rel = hv - base.long()[0]
    b = rel.clamp(min=0) >> int(shift[0])
    bc = b.clamp(max=nb - 1)
    lo, hi = bkt.long()[bc], bkt.long()[bc + 1]
    hd_ids = []
    for _ in range(steps):
        act = lo < hi
        mid = ((lo + hi) >> 1).clamp(0, nd - 1)
        hd_ids.append(mid[act])
        less = hdv[mid] < hv
        lo = torch.where(act & less, mid + 1, lo)
        hi = torch.where(act & ~less, mid, hi)
    d = lo.clamp(max=nd - 1)
    probe = (rel >= 0) & (b < nb) & (lo < nd)
    hd_ids.append(d[probe])
    found = probe & (hdv[d] == hv)
    zero = torch.zeros(1, dtype=torch.long, device=hv.device)
    return {"base": zero, "shift": zero, "bkt": torch.cat([bc, bc + 1]) >> 3,
            "hd": torch.cat(hd_ids) >> 3,
            "crs": torch.cat([d[found], d[found] + 1]) >> 3}


def _dsoft_steps(args, kw: dict) -> dict:
    """The plain version's first steps (dsoft/device.py) on a D-SOFT
    call's inputs: the minimizer scan, the lookups, the passing and kept
    minimizers, and each read-strand's tuple count cum[:, -1]."""
    import torch

    from darwin_tpu_torch.dsoft import device as dd

    queries, qlens, th, _ = args
    LP = queries.shape[1] + 16
    emit, pos, mhash = dd._query_minimizers_fixed(
        dd._codes(queries, qlens, LP), qlens, kw["k"], kw["w"])
    start, end = dd._lookup(mhash, th, kw["index"], kw["tl_steps"])
    occ = end - start
    passing = emit & (occ <= kw["kmer_max_occ"])
    rank = torch.cumsum(passing.long(), dim=1)
    keep = passing & (rank <= kw["num_seeds_cap"] + 1)
    cnt = torch.where(keep, occ, 0)
    return dict(LP=LP, emit=emit, pos=pos, mhash=mhash, start=start,
                passing=passing, rank=rank, keep=keep, cnt=cnt,
                cum=torch.cumsum(cnt, dim=1))


def dsoft_work(args, kw: dict) -> dict:
    """The work a D-SOFT call's data needs, from the plain version's
    steps (_dsoft_steps).  A read-strand's scan can stop at its
    (num_seeds_cap + 1)-th passing minimizer, or at the kept minimizer
    whose tuples pass tup_max: nothing after it changes the output.
    Returns "read_bytes" [R] (a read's bytes up to the last k-mer its
    scan needs), "scanned" (positions), "tuples" [R] (min(total,
    tup_max)) and "sectors": by array, the distinct 32-byte sectors
    (int32 entry index // 8) of the index entries the needed lookups
    load and of the table_pos runs of the kept minimizers' tuples."""
    import torch

    _, qlens, th, _ = args
    k, w, tup_max = kw["k"], kw["w"], kw["tup_max"]
    cap1 = kw["num_seeds_cap"] + 1
    s = _dsoft_steps(args, kw)
    LP, emit, pos, mhash, start = (s[x] for x in ("LP", "emit", "pos",
                                                  "mhash", "start"))
    passing, rank, keep, cnt, cum = (s[x] for x in ("passing", "rank",
                                                    "keep", "cnt", "cum"))
    last = (passing & (rank == cap1)) | (keep & (cum > tup_max))
    stop = torch.where(last, pos, LP).min(dim=1).values
    hi = 16 * ((qlens.long() + 15) // 16) - k - w
    end_p = torch.minimum(stop + 1, hi)  # the scan needs [w-1, end_p)
    scanned = (end_p - (w - 1)).clamp(min=0)
    read_bytes = torch.where(
        scanned > 0, torch.minimum(end_p - 1 + k, qlens.long()), 0)
    sectors = _lookup_sectors(
        mhash[emit & (pos[None, :] < end_p[:, None])], th, kw["index"],
        kw["tl_steps"])
    # Each kept minimizer's hits below tup_max: one run of table_pos.
    n = torch.where(keep, cum.clamp(max=tup_max) - (cum - cnt), 0)
    first = start[n > 0] >> 3
    nsec = ((start[n > 0] + n[n > 0] - 1) >> 3) - first + 1
    within = torch.arange(int(nsec.sum()), device=first.device)
    sectors["table_pos"] = (
        torch.repeat_interleave(first, nsec) + within
        - torch.repeat_interleave(torch.cumsum(nsec, 0) - nsec, nsec))
    return {"read_bytes": read_bytes.tolist(),
            "scanned": int(scanned.sum()),
            "tuples": cum[:, -1].clamp(max=tup_max).tolist(),
            "sectors": {a: torch.unique(v) for a, v in sectors.items()}}


def dsoft_bound(args, kw: dict, out) -> dict:
    """A D-SOFT call's bound from the work its data needs (dsoft_work).
    Bytes: the lengths, the reads up to each scan's stop, the distinct
    32-byte sectors of the index and table_pos (each once a call), the
    outputs.
    Operations: a scanned position's k-mer, hash and window minimum (2k
    + 20 + 2w), and each read's tuples sorted and counted
    (sort_count_ops)."""
    work = dsoft_work(args, kw)
    read_bytes = sum(work["read_bytes"])
    sectors = sum(v.numel() for v in work["sectors"].values())
    k, w = kw["k"], kw["w"]
    ops = (work["scanned"] * (2 * k + 20 + 2 * w)
           + sort_count_ops(work["tuples"]))
    res = bound(nbytes(args[1], *out) + read_bytes + 32 * sectors, ops)
    t = sorted(work["tuples"])
    log(f"  dsoft_device bound: {read_bytes} read bytes, {sectors} "
        f"sectors, {work['scanned']} scanned positions, "
        f"{sum(t)} tuples; min(total, tup_max) a read-strand: max {t[-1]}, "
        f"p99 {t[(99 * len(t) - 1) // 100]}, mean {sum(t) / len(t):.1f} "
        f"(the kernel's shared-memory budget {DSOFT_SMEM_TUPLES})")
    return res


def dsoft_large_reads(args, kw: dict) -> tuple:
    """How csrc/dsoft.cu's dsoft_large takes a call on the card: (the
    read-strands past the shared-memory tuple budget, which it runs, from
    the plain version's totals; whether its arrays lie in device memory,
    as the scratch the call needs past the list of those reads shows)."""
    import torch

    from darwin_tpu_torch import _build

    tup_max, R = kw["tup_max"], args[0].shape[0]
    if tup_max <= DSOFT_SMEM_TUPLES:
        return 0, False
    total = _dsoft_steps(args, kw)["cum"][:, -1].clamp(max=tup_max)
    sms = torch.cuda.get_device_properties(
        args[0].device).multi_processor_count
    need = _build.host_call("dtt_dsoft_scratch_bytes", R, tup_max,
                            kw["num_seeds_cap"], sms)
    return (int((total > DSOFT_SMEM_TUPLES).sum()),
            need > (4 * (R + 1) + 15) // 16 * 16)


def _same(got, want) -> bool:
    """Whether two tuples of tensors are equal, shapes and values."""
    import torch

    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


def phase_dsoft(dev) -> tuple:
    """The D-SOFT kernel against its plain version (all four outputs,
    tolerance 0) under each index mode on the E.coli slice's read-strands
    and on dsoft_cases (where no read overflowed, also the golden
    dsoft_scalar's candidates; the large path must run reads from shared
    memory and from device memory); then timed at the E.coli shape under
    the default index mode.  Returns (its kernels-line numbers, the plain
    version's overflowed reads at that shape)."""
    import numpy as np

    from darwin_tpu_torch.dsoft.device import (default_index_mode,
                                               dsoft_device_batch,
                                               dsoft_device_batch_torch)
    from darwin_tpu_torch.golden.dsoft import dsoft_scalar

    res = {"max_abs_err": 0, "library_ms": None}
    default = default_index_mode(_ecoli_seed_inputs()[2].k)
    for index in ("twolevel", "searchsorted", "dense"):
        t0 = time.perf_counter()
        args, kw = ecoli_dsoft_inputs(dev, index)
        want = dsoft_device_batch_torch(*args, **kw)
        got = dsoft_device_batch(*args, **kw)
        if not _same(got, want):
            raise AssertionError(f"dsoft_device differs on the E.coli "
                                 f"read-strands ({index})")
        log(f"  dsoft_device, E.coli {args[0].shape[0]} read-strands, "
            f"{index}: exact, {int(got[2].sum())} candidates, "
            f"{int(got[3].sum())} overflowed "
            f"({time.perf_counter() - t0:.1f} s)")
        if index == default:
            timed = (args, kw, got)
    large = {"shared memory": 0, "device memory": 0}
    for name, gt, reads, ckw in dsoft_cases():
        gold = [dsoft_scalar(gt, r, ckw["num_seeds_cap"], ckw["threshold"],
                             ckw["max_candidates"]) for r in reads]
        for index in ("twolevel", "searchsorted", "dense"):
            args, kw = dsoft_case_args(gt, reads, ckw, index, dev)
            if index == "twolevel":
                n_large, in_dev = dsoft_large_reads(args, kw)
                large["device memory" if in_dev else "shared memory"] += (
                    n_large)
            got = dsoft_device_batch(*args, **kw)
            if not _same(got, dsoft_device_batch_torch(*args, **kw)):
                raise AssertionError(f"dsoft_device differs: {name}, "
                                     f"{index}")
            hits, offs, counts, over = (x.cpu().numpy() for x in got)
            for i, g in enumerate(gold):
                if not over[i] and list(zip(
                        hits[i, :counts[i]].tolist(),
                        offs[i, :counts[i]].tolist())) != g:
                    raise AssertionError(f"dsoft_device != dsoft_scalar: "
                                         f"{name}, {index}, read {i}")
        log(f"  dsoft_device, {name}: exact under each index mode, "
            f"{int(over.sum())} of {len(reads)} reads overflowed, "
            f"{int(counts.sum())} candidates, {n_large} in the large path"
            f"{' from device memory' if in_dev else ''}")
    if not all(large.values()):
        raise AssertionError(f"dsoft_cases left a form of the large path "
                             f"untested (its reads: {large})")
    args, kw, got = timed
    res.update(dsoft_bound(args, kw, got))
    res["ms"] = median_ms(lambda: dsoft_device_batch(*args, **kw), 20)
    res["plain_ms"] = median_ms(
        lambda: dsoft_device_batch_torch(*args, **kw), 3)
    res["device_ms"] = graph_ms(lambda: dsoft_device_batch(*args, **kw),
                                n=10)
    log(f"  dsoft_device at R={args[0].shape[0]} L={args[0].shape[1]} "
        f"({default}, tup_max {TUP_MAX}, cand_max {CAND_MAX}): kernel "
        f"{res['ms']:.4f} ms (graph {res['device_ms']:.4f} ms), plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})")
    # The throughput shape: the read-strands ten times over, whose
    # outputs repeat those above.
    big = ecoli_x10(args)
    got10 = dsoft_device_batch(*big, **kw)
    if not _same(got10, [x.repeat(10, *[1] * (x.dim() - 1)) for x in got]):
        raise AssertionError("dsoft_device at R = 9200 differs from the "
                             "R = 920 outputs it repeats")
    r10 = dsoft_bound(big, kw, got10)
    r10["ms"] = median_ms(lambda: dsoft_device_batch(*big, **kw), 10)
    r10["device_ms"] = graph_ms(lambda: dsoft_device_batch(*big, **kw), n=5)
    res["r9200"] = r10
    log(f"  dsoft_device at R={big[0].shape[0]}: kernel {r10['ms']:.4f} ms "
        f"(graph {r10['device_ms']:.4f} ms), bound {r10['bound_ms']:.4f} ms "
        f"({r10['bound_by']})")
    return res, int(np.asarray(got[3].cpu()).sum())


def seed_times(dev) -> dict:
    """`--index-modes`: the E.coli slice's D-SOFT on its merged bank in
    one process: the
    native host collect_calls, and collect_calls_device under each index
    mode on a table with nothing cached (its index built and uploaded:
    "cold"), then again ("warm"), each call ending in its GACT calls on
    the host, which must equal collect_calls'; with each mode's kernel
    time (CUDA events, median of 20).  Returns {mode: {cold_s, warm_s,
    kernel_ms}} and "host_s"."""
    import copy

    import torch

    from darwin_tpu_torch.dsoft.device import dsoft_device_batch
    from darwin_tpu_torch.pipeline import (collect_calls,
                                           collect_calls_device)

    params, genome, table, merged, _, _ = _ecoli_seed_inputs()
    fields = ("ref_id", "query_id", "ref_pos", "query_pos")
    collect_calls(table, genome, merged, params)  # warm the native library
    t0 = time.perf_counter()
    host = collect_calls(table, genome, merged, params)
    out = {"host_s": time.perf_counter() - t0}
    for index in ("twolevel", "searchsorted", "dense"):
        fresh = copy.copy(table)
        fresh.__dict__.pop("_device_index", None)
        fresh.__dict__.pop("_twolevel", None)
        times = []
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            calls = collect_calls_device(fresh, genome, merged, params,
                                         index=index, device=dev)
            times.append(time.perf_counter() - t0)
            if len(calls) != len(host) or any(
                    (getattr(calls, f) != getattr(host, f)).any()
                    for f in fields):
                raise AssertionError(f"collect_calls_device ({index}) != "
                                     f"collect_calls on the E.coli slice")
        args, kw = ecoli_dsoft_inputs(dev, index)
        out[index] = dict(cold_s=times[0], warm_s=times[1],
                          kernel_ms=median_ms(
                              lambda: dsoft_device_batch(*args, **kw), 20))
        log(f"  collect_calls_device, E.coli merged bank, {index}: cold "
            f"{times[0]:.4f} s, warm {times[1]:.4f} s, kernel "
            f"{out[index]['kernel_ms']:.4f} ms; the native host "
            f"collect_calls {out['host_s']:.4f} s; calls equal")
    return out


def phase_kernels(dev) -> dict:
    """Each main-path kernel against its plain version on the card;
    returns {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms}}, with device_ms (and library_device_ms where there is
    a library call) for the main path's kernels, and the span fetch's
    one-set numbers under "one_set"."""
    import numpy as np
    import torch

    from darwin_tpu_torch.lab.geom_sweep import max_abs_err
    from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF
    from darwin_tpu_torch.ops.dp import PACKERS, align_tiles
    from darwin_tpu_torch.ops.reference_dp import align_tiles_torch
    from darwin_tpu_torch.ops.swscore import (local_score_batch,
                                              local_score_batch_torch)
    from darwin_tpu_torch.ops.tile_fetch import (fetch_tile_pair,
                                                 fetch_tile_pair_torch,
                                                 fetch_tiles,
                                                 fetch_tiles_torch)

    rng = np.random.default_rng(0)
    wrng = np.random.default_rng(1)
    res = {k: {"max_abs_err": 0} for k in
           ("align_tiles", "fetch_tiles", "local_score_batch",
            *WALKERS.values())}
    timed = {}
    library = {}  # one PyTorch call computing a kernel's function
    for T, ET in TILES:
        ref, query, rlen, qlen = (torch.from_numpy(x).to(dev) for x in
                                  related_tiles(rng, B_MAIN, T))
        first = torch.from_numpy(rng.random(B_MAIN) < 0.5).to(dev)
        for sc in SCORINGS:
            kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                          sc))
            main = (T, sc) == (T_MAIN, SCORINGS[0])
            got = align_tiles(ref, query, rlen, qlen, **kw)
            want = align_tiles_torch(ref, query, rlen, qlen, **kw)
            errs = {"align_tiles": max_abs_err(got, want)}
            if main:
                a = (ref, query, rlen, qlen)
                timed["align_tiles"] = (
                    lambda a=a, kw=kw: align_tiles(*a, **kw),
                    lambda a=a, kw=kw: align_tiles_torch(*a, **kw))
                res["align_tiles"].update(dp_bound(*a, got))
            walks = []
            for fmt, name in WALKERS.items():
                out = (got if fmt == "bytes" else
                       align_tiles(ref, query, rlen, qlen, dir_format=fmt,
                                   **kw))
                args = (out["dir" if fmt == "bytes" else "dir_words"], rlen,
                        qlen, first, out["max_i"], out["max_j"])
                kernel, plain = _walker_pairs(fmt, ET, args)
                g, w = kernel(), plain()
                errs[name] = max_abs_err(dict(enumerate(g)),
                                         dict(enumerate(w)))
                walks.append(float((g[1] + g[2]).float().mean()))
                if main:
                    timed[name] = (kernel, plain)
                    res[name].update(walk_bound(args, g))
            log(f"  T={T} ET={ET} scoring={sc}: errors {errs}, mean walk "
                f"{walks[0]:.1f} steps")
            if any(errs.values()):
                raise AssertionError(f"kernel mismatch at T={T} {sc}")
            for k, e in errs.items():
                res[k]["max_abs_err"] = max(res[k]["max_abs_err"], e)
        dirm, *rest = (torch.from_numpy(x).to(dev)
                       for x in walk_case_batch(wrng, T, B_MAIN))
        for fmt, name in WALKERS.items():
            packer = PACKERS[fmt]
            kernel, plain = _walker_pairs(
                fmt, ET, (dirm if packer is None else packer(dirm), *rest))
            g = kernel()
            e = max_abs_err(dict(enumerate(g)), dict(enumerate(plain())))
            log(f"  T={T} ET={ET} walk_cases, {name}: error {e}, mean walk "
                f"{float((g[1] + g[2]).float().mean()):.1f} steps")
            if e:
                raise AssertionError(f"{name} mismatch on walk_cases, T={T}")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], e)
    # Early terminates past the walkers' old shared-buffer caps.
    for case, fmt, args, ET in large_et_walks(dev):
        kernel, plain = _walker_pairs(fmt, ET, args)
        t0 = time.perf_counter()
        g = kernel()
        e = max_abs_err(dict(enumerate(g)), dict(enumerate(plain())))
        log(f"  {case}: error {e}, longest walk "
            f"{int((g[1] + g[2]).max())} steps "
            f"({time.perf_counter() - t0:.1f} s)")
        if e:
            raise AssertionError(f"{case} differs from its plain version")
        name = WALKERS[fmt]
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], e)

    # The span fetch in both forms: the pair (the engine's one launch an
    # iteration) and one set.
    frng = np.random.default_rng(2)
    gbank, qbank = fetch_banks(frng, dev)
    for T, _ in TILES:
        g_start, rl = fetch_spans(frng, gbank.shape[0], T, dev)
        q_start, ql = fetch_spans(frng, qbank.shape[0], T, dev)
        back = torch.from_numpy(frng.random(B_MAIN) < 0.5).to(dev)
        pair = (gbank, qbank, g_start, q_start, rl, ql, back)
        pkw = dict(T=T, pad_ref=PAD_REF, pad_query=PAD_QUERY)
        one = (qbank, q_start, ql, back)
        okw = dict(T=T, pad=PAD_QUERY)
        got = fetch_tile_pair(*pair, **pkw)
        want = fetch_tile_pair_torch(*pair, **pkw)
        got1 = fetch_tiles(*one, **okw)
        e = max_abs_err(dict(enumerate((*got, got1))),
                        dict(enumerate((*want, want[1]))))
        log(f"  fetch_tile_pair and fetch_tiles T={T}: err {e}")
        if e:
            raise AssertionError(f"fetch mismatch at T={T}")
        res["fetch_tiles"]["max_abs_err"] = max(
            res["fetch_tiles"]["max_abs_err"], e)
        if T == T_MAIN:
            timed["fetch_tiles"] = (
                lambda p=pair, k=pkw: fetch_tile_pair(*p, **k),
                lambda p=pair, k=pkw: fetch_tile_pair_torch(*p, **k))
            timed[ONE_SET] = (lambda a=one, k=okw: fetch_tiles(*a, **k),
                              lambda a=one, k=okw: fetch_tiles_torch(*a, **k))
            sets = [(gbank, g_start, rl, PAD_REF),
                    (qbank, q_start, ql, PAD_QUERY)]
            res["fetch_tiles"].update(fetch_bound(sets, back, got))
            res[ONE_SET] = dict(max_abs_err=e,
                                **fetch_bound(sets[1:], back, got[1:]))
            library["fetch_tiles"] = gather_yardstick(sets, back, T, got)
            library[ONE_SET] = gather_yardstick(sets[1:], back, T, got[1:])

    # Score-only SW at B = 64 on 200-3000 base pairs, from a generator of
    # its own, so that other phases' draws do not change its inputs.
    sw = [torch.from_numpy(x).to(dev)
          for x in sw_pairs(np.random.default_rng(3), SW_B, SW_LEN)]
    for sc in SCORINGS[:2]:
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), sc))
        got = local_score_batch(*sw, **kw)
        e = max_abs_err({0: got}, {0: local_score_batch_torch(*sw, **kw)})
        log(f"  SW B={SW_B} up to {SW_LEN} bases, scoring={sc}: err {e}, "
            f"mean score {float(got.float().mean()):.1f}")
        if e or not bool((got[2:] > 0).all()):
            raise AssertionError(f"SW mismatch under {sc}")
        res["local_score_batch"]["max_abs_err"] = max(
            res["local_score_batch"]["max_abs_err"], e)
    # At the tiling's edges, from a generator of its own.
    erng = np.random.default_rng(4)
    for LR, LQ in sw_edge_shapes():
        edge = [torch.from_numpy(x).to(dev)
                for x in sw_edge_pairs(erng, SW_B, LR, LQ)]
        for sc in SCORINGS:
            kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                          sc))
            e = max_abs_err({0: local_score_batch(*edge, **kw)},
                            {0: local_score_batch_torch(*edge, **kw)})
            if e:
                raise AssertionError(f"SW mismatch at LR={LR} LQ={LQ} {sc}")
    log(f"  SW B={SW_B} at {len(sw_edge_shapes())} edge shapes x "
        f"{len(SCORINGS)} scorings: exact")
    # Timed on pairs of exactly 3 kb.
    sw[2].fill_(SW_LEN)
    sw[3].fill_(SW_LEN)
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                  SCORINGS[0]))
    timed["local_score_batch"] = (lambda: local_score_batch(*sw, **kw),
                                  lambda: local_score_batch_torch(*sw, **kw))
    cells = int((sw[2].long() * sw[3].long()).sum())
    res["local_score_batch"].update(bound(
        nbytes(*sw, local_score_batch(*sw, **kw)), SW_OPS_CELL * cells))

    for name, (kernel, plain) in timed.items():
        r = res[name]
        r["ms"] = median_ms(kernel, 20)
        r["plain_ms"] = median_ms(plain, 3 if name == "local_score_batch"
                                  else 5)
        r["library_ms"] = (median_ms(library[name], 20)
                           if name in library else None)
        device = ""
        if name in DEVICE_TIMED:
            r["device_ms"] = graph_ms(kernel)
            device = f" (graph {r['device_ms']:.4f} ms"
            if name in library:
                r["library_device_ms"] = graph_ms(library[name])
                device += f", library graph {r['library_device_ms']:.4f} ms"
            device += ")"
        shape = (f"B={SW_B} {SW_LEN}x{SW_LEN}" if name == "local_score_batch"
                 else f"B={B_MAIN} T={T_MAIN}")
        log(f"  {name} at {shape}: kernel {r['ms']:.4f} ms{device}, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    # SW's device time on eight times the timed pairs (the same pairs
    # repeated: blocks share SMs), whose scores repeat the timed ones'.
    sw8 = [x.repeat(8, *[1] * (x.dim() - 1)) for x in sw]
    if not torch.equal(local_score_batch(*sw8, **kw),
                       local_score_batch(*sw, **kw).repeat(8)):
        raise AssertionError("SW's scores of repeated pairs differ")
    b8 = graph_ms(lambda: local_score_batch(*sw8, **kw), n=10)
    res["local_score_batch"]["device_ms_8x_pairs"] = b8
    log(f"  local_score_batch B={8 * SW_B} at {SW_LEN}x{SW_LEN}: device "
        f"{b8:.4f} ms")
    one_set = res.pop(ONE_SET)
    res["fetch_tiles"]["one_set"] = one_set
    log(f"  fetch: the pair's device time is "
        f"{res['fetch_tiles']['device_ms'] / one_set['device_ms']:.2f}x one "
        f"set's")
    return res


def phase_fixtures(dev) -> None:
    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.io.fasta import parse_fasta
    from darwin_tpu_torch.pipeline import run_pipeline

    fixtures = sorted(p.parent for p in DATA.glob("*/out.darwin"))
    if not fixtures:
        raise AssertionError(f"no fixtures under {DATA}")
    for d in fixtures:
        params = Params.from_cfg(d / "params.cfg")
        reads = parse_fasta(d / "reads.fasta")
        same_file = not (d / "ref.fasta").exists()
        ref = reads if same_file else parse_fasta(d / "ref.fasta")
        want = set((d / "out.darwin").read_text().splitlines())
        for engine, dsoft in (("device", "host"), ("host", "host"),
                              ("device", "device")):
            t0 = time.perf_counter()
            res = run_pipeline(ref, reads, params, same_file, batch_size=64,
                               engine=engine, dsoft=dsoft, device=dev)
            got = set(res.records)
            log(f"  {d.name} ({engine}, --dsoft {dsoft}): {len(got)}/"
                f"{len(want)} records, {time.perf_counter() - t0:.2f} s")
            if got != want:
                raise AssertionError(
                    f"{d.name} ({engine}, --dsoft {dsoft}): missing "
                    f"{sorted(want - got)[:3]} extra {sorted(got - want)[:3]}")


def _counted(counters: dict, run) -> tuple:
    """run() with every launch counter zeroed just before it; returns
    (its result, {kernel: launches in it})."""
    for c in counters.values():
        c.launches = 0
    out = run()
    return out, {name: c.launches for name, c in counters.items()}


def phase_ecoli(dev, counters: dict, plain_overflow: int,
                drains: dict) -> dict:
    """The five E.coli-shaped runs; returns {kernel: launches} summed
    over them.  The --dsoft device run must report plain_overflow
    overflowed reads (the plain version's count on the same
    read-strands, phase 2).  Fills drains with each device engine run's
    {tag: (the drain gate's (tail, total) where the run shows it,
    drain_redispatches)} (phase 10 checks them)."""
    from darwin_tpu_torch import cli, native
    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.eval.sensitivity import measure_sensitivity
    from darwin_tpu_torch.index.genome import Genome
    from darwin_tpu_torch.index.seed_table import SeedTable
    from darwin_tpu_torch.io.fasta import parse_fasta, write_fasta
    from darwin_tpu_torch.pipeline import (format_records, make_merged_engine,
                                           read_banks, run_device_merged)

    want_sha = (DATA / "ecoli_shape" / "dataset.sha256").read_text().strip()
    want = (DATA / "ecoli_shape" / "jax_cpu.darwin").read_text()
    total = dict.fromkeys(counters, 0)
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
        params = Params()  # the reference's defaults, as the CLI's

        def cli_run(tag, *extra):
            out = td / tag
            # No params.cfg in td: the reference's default params.
            rc = cli.main([str(fa), str(fa), "--params",
                           str(td / "params.cfg"), "--batch-size", "512",
                           "--out-dir", str(out), "--merged-out",
                           str(out / "merged.darwin"), "--metrics-json",
                           str(out / "metrics.json"), *extra])
            if rc != 0:
                raise AssertionError(f"cli exited {rc}")
            return ((out / "merged.darwin").read_text(),
                    json.loads((out / "metrics.json").read_text()))

        def engine_run(fmt):
            reads = parse_fasta(fa)
            genome = Genome(reads, params.bin_size)
            t0 = time.perf_counter()
            table = SeedTable.build(genome.concat, params.seed_size,
                                    params.seed_occurence_multiple,
                                    params.bin_size, params.window_size)
            m = {"seed_table_s": time.perf_counter() - t0,
                 "host_native": native.available()}
            fwd, rev = read_banks(reads)
            prebuilt = make_merged_engine(
                genome, fwd, rev, params, same_file=True, batch_size=512,
                device=dev, tb_format=fmt)
            recs, cc = run_device_merged(
                genome, table, fwd, rev, params, same_file=True,
                batch_size=512, prebuilt=prebuilt, metrics=m)
            m["drain_gate"] = prebuilt[0].last_drain_gate
            lines = sorted(set(format_records(genome, reads, recs)))
            m["num_candidates"] = sum(cc)
            return "".join(line + "\n" for line in lines), m

        runs = {
            "cli bytes": lambda: cli_run("bytes"),
            "packed": lambda: engine_run("packed"),
            "packed6": lambda: engine_run("packed6"),
            "cli host --paf-out": lambda: cli_run(
                "host", "--engine", "host", "--paf-out",
                str(td / "host" / "merged.paf")),
            "cli bytes --dsoft device": lambda: cli_run(
                "dsoft_device", "--dsoft", "device"),
        }
        seed_s = {}
        for tag, run in runs.items():
            t0 = time.perf_counter()
            (got, m), launches = _counted(counters, run)
            wall = time.perf_counter() - t0
            n_got = len(got.splitlines())
            log(f"  {tag}: records {n_got} (expected "
                f"{len(want.splitlines())}), wall {wall:.3f} s, seed_s "
                f"{m['seed_s']:.3f}, align_s {m['align_s']:.3f}, seed table "
                f"{m['seed_table_s']:.3f} s, engine iterations "
                f"{m['engine_iters']}, candidates {m['num_candidates']}, "
                f"reads/s {460 / (m['seed_s'] + m['align_s']):.1f}, "
                f"host_native {m['host_native']}")
            log(f"    launches: {launches}")
            if m["host_native"] is not True:
                raise AssertionError("the host stages ran their NumPy "
                                     "fallbacks: darwin_tpu_torch.native "
                                     "did not build")
            if got != want:
                w, g = set(want.splitlines()), set(got.splitlines())
                raise AssertionError(
                    f"E.coli records differ ({tag}): missing "
                    f"{sorted(w - g)[:3]} extra {sorted(g - w)[:3]}")
            idle = [k for k in ECOLI_RUNS[tag] if launches[k] <= 0]
            if idle:
                raise AssertionError(f"{tag}: {idle} not launched")
            if ("fetch_tiles" in ECOLI_RUNS[tag]
                    and launches["fetch_tiles"] != m["engine_iters"]):
                raise AssertionError(
                    f"{tag}: fetch_tiles launched {launches['fetch_tiles']} "
                    f"times in {m['engine_iters']} engine iterations, not "
                    f"once an iteration")
            for k, n in launches.items():
                total[k] += n
            seed_s[tag] = m["seed_s"]
            if "fetch_tiles" in ECOLI_RUNS[tag]:
                drains[tag] = (m.get("drain_gate"), m["drain_redispatches"])
            if "--dsoft device" in tag:
                log(f"    dsoft_overflow_reads {m['dsoft_overflow_reads']} "
                    f"(the plain version flags {plain_overflow})")
                if m["dsoft_overflow_reads"] != plain_overflow:
                    raise AssertionError(f"{tag}: dsoft_overflow_reads "
                                         f"{m['dsoft_overflow_reads']}, the "
                                         f"plain version {plain_overflow}")
        log("  seed_s: " + ", ".join(f"{t} {v:.4f} s"
                                     for t, v in seed_s.items()))
        names = [r.name for r in parse_fasta(fa)]
        ev = measure_sensitivity(want.splitlines(), names)
        log(f"  sensitivity {ev.sensitivity:.6f}, specificity "
            f"{ev.specificity:.6f} (TP {ev.tp}, FN {ev.fn}, FP {ev.fp}; "
            f"the same for every run: their records are equal)")
        paf = (td / "host" / "merged.paf").read_text().splitlines()
    # PAF lines also carry nmatch and ncols, so records that print the
    # same .out line may be distinct PAF lines: compare what both carry.
    got_keys = {(c[5], c[0], int(c[7]), int(c[8]), c[12][5:], c[4] == "-")
                for c in (ln.split("\t") for ln in paf)}
    want_keys = {(f[1], f[3], int(f[5]), int(f[7]), f[13], f[15] == "1")
                 for f in (ln.replace(",", "").split()
                           for ln in want.splitlines())}
    log(f"  PAF: {len(paf)} lines, {len(got_keys)} distinct records")
    if got_keys != want_keys:
        raise AssertionError("PAF records differ from the .out records")
    return total


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
    from darwin_tpu_torch.ops.scanshift import (STEPS, scanshift_shfl,
                                                scanshift_smem,
                                                scanshift_torch)

    from darwin_tpu_torch.ops.traceback import (traceback_packed,
                                                 traceback_packed6)

    scans = {"scanshift_shfl": scanshift_shfl,
             "scanshift_smem": scanshift_smem}
    counters = (align_tiles, plane2, traceback_packed, traceback_packed6,
                *scans.values())
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
    for exp in ("byte_full", "packed", "packed6", "p6compact", "tbunroll"):
        lab.run(exp, "packed")
    plane2_probe.probe_emit(376, dev, B=2048, V=2)
    plane2_probe.probe_gather(376, dev, B=2048, V=2)
    scanshift_probe.run(376, dev, B=2048, V=8)
    launches = {name: align_tiles.variant_launches[v]
                for v, name in DP_VARIANTS.items()}
    launches["plane2"] = plane2.launches
    launches.update({k: f.launches for k, f in scans.items()})
    launches.update(traceback_packed=traceback_packed.launches,
                    traceback_packed6=traceback_packed6.launches)
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
                    name = DP_VARIANTS[(fmt, il)]
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
            name = DP_VARIANTS[(fmt, il)]
            call = (lambda: align_tiles(ref, query, rlen, qlen,
                                        dir_format=fmt, interleave=il, **kw))
            res[name].update(dp_bound(ref, query, rlen, qlen, call()))
            res[name]["ms"] = median_ms(call, 20)
            res[name]["plain_ms"] = plain_ms
            res[name]["library_ms"] = None
            log(f"  {name} at B={B_MAIN} T={T_MAIN}: kernel "
                f"{res[name]['ms']:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{res[name]['bound_ms']:.4f} ms ({res[name]['bound_by']})")

    # Plane 2 timed at the probe's shape, B = 2048, T = 376.
    refs, queries = (torch.from_numpy(x[0]).to(dev) for x in
                     related_batches(1, 2048, 376))
    lens = torch.full((2048,), 376, dtype=torch.int32, device=dev)
    kw = SCORING
    out = plane2(refs, queries, lens, lens, **kw)
    e = max_abs_err(out, plane2_torch(refs, queries, lens, lens, **kw))
    res["plane2"].update(dp_bound(refs, queries, lens, lens, out))
    res["plane2"]["library_ms"] = None
    res["plane2"]["max_abs_err"] = max(res["plane2"]["max_abs_err"], e)
    if e:
        raise AssertionError("plane2 mismatch at B=2048 T=376")
    res["plane2"]["ms"] = median_ms(
        lambda: plane2(refs, queries, lens, lens, **kw), 10)
    res["plane2"]["plain_ms"] = median_ms(
        lambda: plane2_torch(refs, queries, lens, lens, **kw), 3)
    log(f"  plane2 at B=2048 T=376: kernel {res['plane2']['ms']:.4f} ms, "
        f"plain {res['plane2']['plain_ms']:.4f} ms, bound "
        f"{res['plane2']['bound_ms']:.4f} ms ({res['plane2']['bound_by']})")

    # The scans at B = 2048, TJP = 384, 16 chained scans a row.
    x = torch.from_numpy(scanshift_probe.probe_inputs(1, 2048, 376)[0][0]
                         ).to(dev)
    want = scanshift_torch(x)
    plain_ms = median_ms(lambda: scanshift_torch(x), 5)
    # The one-call yardstick: torch.cummax, one of the 16 chained scans.
    cummax_ms = median_ms(lambda: torch.cummax(x, dim=1), 20)
    for name, fn in scans.items():
        e = max_abs_err({0: fn(x)}, {0: want})
        if e:
            raise AssertionError(f"{name} mismatch at TJP=384")
        res[name] = dict(max_abs_err=e, ms=median_ms(lambda: fn(x), 20),
                         device_ms=graph_ms(lambda: fn(x)),
                         plain_ms=plain_ms, library_ms=cummax_ms,
                         **bound(2 * nbytes(x),
                                 SCAN_OPS * STEPS * x.numel()))
        log(f"  {name} at B=2048 TJP=384: kernel {res[name]['ms']:.4f} ms "
            f"(graph {res[name]['device_ms']:.4f} ms), plain "
            f"{plain_ms:.4f} ms, one torch.cummax {cummax_ms:.4f} ms, bound "
            f"{res[name]['bound_ms']:.4f} ms")
    for C in SCAN_WIDTHS:
        xe = scan_edge_input(C, dev)
        want = scanshift_torch(xe)
        for name, fn in scans.items():
            if not torch.equal(fn(xe), want):
                raise AssertionError(f"{name} mismatch at C={C}")
    log(f"  both scans at B={SCAN_EDGE_B}, C in {SCAN_WIDTHS}: exact")
    return res, launches


def phase_scoreeval(dev) -> int:
    """The score evaluator on the card; returns the SW kernel's launches
    in its run."""
    import numpy as np
    import torch

    from darwin_tpu_torch import cli
    from darwin_tpu_torch.eval import score_eval
    from darwin_tpu_torch.eval.datagen import synth_genome, two_readsets
    from darwin_tpu_torch.io.fasta import revcomp, write_fasta
    from darwin_tpu_torch.ops.swscore import (local_score_batch,
                                              local_score_batch_torch)

    rng = np.random.default_rng(7)
    a, b = two_readsets(synth_genome(100_000, rng), 40, 4000, rng,
                        error_rate=0.05, rc_fraction=0.5)
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        write_fasta(td / "set1.fasta", a)
        write_fasta(td / "set2.fasta", b)
        merged = td / "merged.darwin"
        t0 = time.perf_counter()
        rc = cli.main([str(td / "set1.fasta"), str(td / "set2.fasta"),
                       "--params", str(td / "params.cfg"), "--device", "cuda",
                       "--out-dir", str(td / "out"), "--merged-out",
                       str(merged)])
        if rc != 0:
            raise AssertionError(f"cli exited {rc}")
        n_rec = len(merged.read_text().splitlines())
        log(f"  overlapped: {n_rec} records, {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        (rc, launches) = _counted(
            {"local_score_batch": local_score_batch},
            lambda: score_eval.main([str(merged), str(td / "set1.fasta"),
                                     str(td / "set2.fasta")]))
        launches = launches["local_score_batch"]
        log(f"  score_eval rc {rc}, {time.perf_counter() - t0:.2f} s, SW "
            f"launches {launches}")
        if rc != 0 or launches <= 0:
            raise AssertionError(f"score_eval: rc {rc}, {launches} launches")
    # The exact scores of every theoretical pair, both strands, from the
    # kernel and from the plain version on the same inputs.
    pairs = score_eval.theoretical_pairs([n for n, _ in a],
                                         [n for n, _ in b], 1000)
    seq_pairs = [(a[i][1], s) for i, j in pairs
                 for s in (b[j][1], revcomp(b[j][1]))]
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    diff = 0
    for lo in range(0, len(seq_pairs), 64):
        args = [torch.from_numpy(x).to(dev) for x in
                score_eval.pair_arrays(seq_pairs[lo:lo + 64])]
        diff += int((local_score_batch(*args, **kw)
                     != local_score_batch_torch(*args, **kw)).sum())
    log(f"  {len(seq_pairs)} exact pair scores ({len(pairs)} pairs x 2 "
        f"strands): {diff} differ between kernel and plain version")
    if diff or not pairs:
        raise AssertionError(f"SW kernel and plain version differ on {diff} "
                             f"of {len(seq_pairs)} pairs")
    return launches


def _fuzz_soak():
    """tools/torch_fuzz_soak.py as a module (its directory put on
    sys.path, which spawned workers inherit)."""
    tools = str(REPO / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import torch_fuzz_soak

    return torch_fuzz_soak


def golden_soak_start(pool) -> dict:
    """The golden spec's record sets of tests/test_fuzz_pipeline.py's
    pinned instances, submitted to pool: {(seed, guided): future}."""
    fz = _fuzz_soak()
    return {(seed, guided): pool.submit(fz.golden_records, seed, guided)
            for guided, seeds in ((False, fz.PINNED),
                                  (True, fz.PINNED_GUIDED))
            for seed in seeds}


def phase_golden(dev, futures: dict) -> None:
    """Each pinned fuzz instance through the port's pipeline on the card
    against the golden spec's records (from futures), and its device
    D-SOFT's calls against the host D-SOFT's (torch_fuzz_soak.check)."""
    fz = _fuzz_soak()
    for (seed, guided), fut in futures.items():
        t0 = time.perf_counter()
        want = fut.result()
        waited = time.perf_counter() - t0
        bad = fz.check(seed, guided, dev, want)
        log(f"  seed {seed}{' guided' if guided else ''}: {len(want)} "
            f"records, {'exact' if not bad else bad} "
            f"({time.perf_counter() - t0:.1f} s, {waited:.1f} s of it "
            f"waiting for the golden spec)")
        if bad:
            raise AssertionError(f"golden soak seed {seed} (guided "
                                 f"{guided}): {bad}")


def sharded_fixture(seed, n_reads=16, ref_len=40000, err=0.12,
                    repetitive=False, unit=500):
    """tests/test_sharded_table.py's _fixture on the port's golden table:
    (GoldenSeedTable of a 40 kb reference, k 12, w 4, bin 64, random or
    tandem repeats of a unit of 500 bases (the fixture's; another unit is
    this copy's own) with 2% jitter; reads of 500-2500 bases from it at
    err substitutions)."""
    import numpy as np

    from darwin_tpu_torch.golden.dsoft import GoldenSeedTable

    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(seed)
    if repetitive:
        rep = rng.choice(alpha, size=unit).astype(np.uint8)
        ref = np.tile(rep, ref_len // unit + 1)[:ref_len].copy()
        jitter = rng.random(ref_len) < 0.02
        ref[jitter] = rng.choice(alpha, size=int(jitter.sum()))
    else:
        ref = rng.choice(alpha, size=ref_len).astype(np.uint8)
    gt = GoldenSeedTable(ref, 12, 32, 64, 4)
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, max(1, ref_len - 3000)))
        r = ref[s:s + int(rng.integers(500, 2500))].copy()
        mut = rng.random(len(r)) < err
        r[mut] = rng.choice(alpha, size=int(mut.sum()))
        reads.append(r)
    return gt, reads


def sharded_case(name: str):
    """(GoldenSeedTable, reads, dsoft_table_sharded's D-SOFT keywords,
    the all-to-all's a2a_cap, (overflow expected under the all-to-all,
    under the all-gather)) of SHARDED_CASES[name]; "positions past 2^31"
    shifts the table's positions by 2.6e9."""
    import numpy as np

    fx, threshold, cap, cand, tup_max, cand_max, a2a, *over = \
        SHARDED_CASES[name]
    gt, reads = sharded_fixture(**fx)
    if name == "positions past 2^31":
        shift = np.uint64(2_600_000_000)
        gt.pos_table = (gt.pos_table.astype(np.uint64)
                        + shift).astype(np.uint32)
        gt.ref_size += int(shift)
    kw = dict(k=gt.k, w=gt.w, bin_size=gt.bin_size,
              kmer_max_occ=gt.kmer_max_occurence, num_seeds_cap=cap,
              threshold=threshold, max_candidates=cand, tup_max=tup_max,
              cand_max=cand_max)
    return gt, reads, kw, a2a, tuple(over)


def sharded_case_args(name: str, dev):
    """(mesh of SHARDED_P entries of dev, queries, qlens, shards, kw, the
    all-to-all's a2a_cap, expected overflows, GoldenSeedTable, reads) of
    one SHARDED_CASES entry."""
    import torch

    from darwin_tpu_torch.dsoft import sharded_table as st
    from darwin_tpu_torch.dsoft.device import pad_reads
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.parallel.mesh import make_mesh

    gt, reads, kw, a2a, over = sharded_case(name)
    mesh = make_mesh(devices=[dev] * SHARDED_P)
    hs, ps = st.make_sharded_table(gt.hashes, gt.pos_table, SHARDED_P)
    di = st.make_sharded_dense_index(hs)
    Q, lens = pad_reads(SeqBank(reads), range(len(reads)))
    kw = dict(kw, dense_steps=di.steps)
    return (mesh, torch.from_numpy(Q).to(dev), torch.from_numpy(lens).to(dev),
            st.place_shards(mesh, hs, ps, di), kw, a2a, over, gt, reads)


def shard_count_case(name: str):
    """(hit [N] uint32, off [N] int32, seg [R + 1] int64, shard_count's
    keywords) of SHARD_COUNT_CASES[name], made with numpy from its seed as
    the exchange groups a shard's tuples: by read, in (offset, hit) order
    within a read, distinct pairs, hit >= offset, with tuples of no read
    before seg[0] and after seg[R].  A read of n tuples holds n // 300 + 1
    planted diagonals of 8-30 tuples in one bin (offsets 3-40 apart,
    which cross threshold), the rest at random diagonals, on a query of
    up to 12 kb; under bin_size 1 a third of the diagonals lie past
    2^31."""
    import numpy as np

    seed, sizes, kw = SHARD_COUNT_CASES[name]
    rng = np.random.default_rng(seed)
    bs = kw["bin_size"]

    def diagonals(m):
        far = rng.random(m) < (1 / 3 if bs == 1 else 0)
        return np.where(far, rng.integers(2 ** 31, 2 ** 32 - 20000, m),
                        rng.integers(0, 2 ** 24, m)) // bs * bs

    def read(n):
        qlen = int(rng.integers(2000, 12000))
        offs, diags = [], []
        for d in diagonals(n // 300 + 1):
            m = int(rng.integers(8, 31))
            offs.append(np.cumsum(rng.integers(3, 41, m)) % qlen)
            diags.append(d + rng.integers(0, bs, m))
        offs.append(rng.integers(0, qlen, 2 * n))
        diags.append(diagonals(2 * n))
        o = np.concatenate(offs).astype(np.uint64)
        h = o + np.concatenate(diags).astype(np.uint64)
        pairs = (o << np.uint64(32)) | h
        _, first = np.unique(pairs, return_index=True)
        keep = np.sort(first)[:n]  # the planted tuples first
        o, h = o[keep], h[keep]
        order = np.lexsort((h, o))
        return h[order].astype(np.uint32), o[order].astype(np.int32)

    parts = [read(n) for n in (37, *sizes, 50)]
    lens = np.array([len(h) for h, _ in parts])
    seg = np.cumsum(np.concatenate([[0], lens]))[1:-1].astype(np.int64)
    return (np.concatenate([h for h, _ in parts]),
            np.concatenate([o for _, o in parts]), seg, dict(kw))


def shard_count_case_args(name: str, dev):
    """shard_count's (hit, off, seg) tensors on dev (hit as int32 bit
    patterns) and keywords of one SHARD_COUNT_CASES entry."""
    import torch

    hit, off, seg, kw = shard_count_case(name)
    return (torch.from_numpy(hit.view("int32")).to(dev),
            torch.from_numpy(off).to(dev), torch.from_numpy(seg).to(dev)), kw


def count_forms(seg) -> tuple:
    """How many reads of seg shard_count takes in each form: (registers,
    shared memory, device memory)."""
    n = (seg[1:] - seg[:-1]).cpu()
    reg = int((n <= SHARD_COUNT_REG_TUPLES).sum())
    dev = int((n > SHARD_COUNT_SMEM_TUPLES).sum())
    return reg, len(n) - reg - dev, dev


# The E.coli slice's budgets by mesh size, derived once a process (a
# host D-SOFT replay of several seconds): phase 7 hands its child the
# MESH entry (--budgets), and phase 9's collector runs pass them.
ECOLI_BUDGETS: dict = {}


def ecoli_budgets(n: int):
    """The E.coli slice's derived budgets at mesh size n (derive_budgets,
    as collect_calls_table_sharded derives them), from ECOLI_BUDGETS."""
    if n not in ECOLI_BUDGETS:
        from darwin_tpu_torch.dsoft.sharded_table import derive_budgets

        params, _, table, merged, _, _ = _ecoli_seed_inputs()
        ECOLI_BUDGETS[n] = derive_budgets(
            table, [merged.slice(i, 0, int(merged.lengths[i]))
                    for i in range(len(merged.lengths))], n,
            num_seeds_cap=params.num_seeds, threshold=params.threshold,
            max_candidates=params.max_candidates)
    return ECOLI_BUDGETS[n]


@functools.lru_cache(maxsize=1)
def ecoli_sharded(dev_name: str):
    """The E.coli slice's table sharded over MESH entries of one device,
    as collect_calls_table_sharded shards it: (mesh, budgets, dense
    index, the shards placed on the mesh)."""
    import torch

    from darwin_tpu_torch.dsoft import sharded_table as st
    from darwin_tpu_torch.parallel.mesh import make_mesh

    _, _, table, _, _, _ = _ecoli_seed_inputs()
    mesh = make_mesh(devices=[torch.device(dev_name)] * MESH)
    hs, ps = st.make_sharded_table(table.hashes, table.pos, MESH)
    di = st.make_sharded_dense_index(hs)
    return mesh, ecoli_budgets(MESH), di, st.place_shards(mesh, hs, ps, di)


def ecoli_sharded_args(dev):
    """dsoft_table_sharded's queries, qlens and D-SOFT keywords on the
    E.coli slice's 920 read-strands with the derived budgets."""
    import torch

    params, _, table, _, Q, lens = _ecoli_seed_inputs()
    _, budgets, di, _ = ecoli_sharded(str(dev))
    return (torch.from_numpy(Q).to(dev), torch.from_numpy(lens).to(dev),
            dict(k=table.k, w=table.w, bin_size=table.bin_size,
                 kmer_max_occ=table.kmer_max_occurence,
                 num_seeds_cap=params.num_seeds, threshold=params.threshold,
                 max_candidates=params.max_candidates,
                 tup_max=budgets.tup_max, cand_max=budgets.cand_max,
                 dense_steps=di.steps))


def shard_scan_bound(args, kw: dict, out) -> dict:
    """A shard_scan call's bound: the reads' bytes, their lengths, the
    outputs (nine bytes a position), the distinct 32-byte sectors of the
    shard's index that its emitted minimizers' lookups load (each once),
    and a scanned position's k-mer, hash and window minimum (2k + 20 + 2w
    operations)."""
    from darwin_tpu_torch.dsoft import device as dd

    queries, qlens, th, di = args
    k, w = kw["k"], kw["w"]
    LP = queries.shape[1] + 16
    emit, _, mhash = dd._query_minimizers_fixed(
        dd._codes(queries, qlens, LP), qlens, k, w)
    dense = kw["index"] == "dense"
    sectors = _lookup_sectors(mhash[emit], di if dense else th,
                              "twolevel" if dense else "searchsorted",
                              kw["dense_steps"])
    nsec = sum(int(v.unique().numel()) for v in sectors.values())
    hi = (16 * ((qlens.long() + 15) // 16) - k - w).clamp(max=LP)
    scanned = int((hi - (w - 1)).clamp(min=0).sum())
    read_bytes = int(qlens.long().clamp(max=queries.shape[1]).sum())
    return bound(read_bytes + nbytes(qlens, *out) + 32 * nsec,
                 scanned * (2 * k + 20 + 2 * w))


def shard_count_bound(args, out) -> dict:
    """A shard_count call's bound: its reads' tuples (hit and offset, each
    read once), seg and the outputs; each read's tuples sorted and
    counted (sort_count_ops)."""
    hit, off, seg = args
    n = (seg[1:] - seg[:-1]).tolist()
    return bound(8 * sum(n) + nbytes(seg, *out), sort_count_ops(n))


def sharded_step_ms(args, kw: dict, reps: int = 5) -> dict:
    """Median ms (over reps runs after one warm run) of each step of
    dsoft_table_sharded(*args, **kw): a CUDA event is recorded at the call's
    start, at each step's end (its mark: "scan" for each entry's scan,
    "tuples", "exchange", and "group" and "count" for each owner) and at
    its return ("end": the outputs gathered), and the time between two
    events goes to the later's step; "total" is the whole call.  So
    "scan" and "count" are the kernels with their launch paths, the rest
    the PyTorch glue, each as the device's clock sees it."""
    import torch

    from darwin_tpu_torch.dsoft import sharded_table as st

    runs = []
    for _ in range(reps + 1):
        events = []

        def mark(step):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append((step, e))

        torch.cuda.synchronize()
        mark("start")
        st.dsoft_table_sharded(*args, mark=mark, **kw)
        mark("end")
        torch.cuda.synchronize()
        t = {}
        for (_, e0), (step, e1) in zip(events, events[1:]):
            t[step] = t.get(step, 0.0) + e0.elapsed_time(e1)
        t["total"] = events[0][1].elapsed_time(events[-1][1])
        runs.append(t)
    return {k: statistics.median(r[k] for r in runs[1:]) for k in runs[1]}


def collect_ms(dev, n: int, exchange: str, reps: int = 5) -> float:
    """collect_calls_table_sharded's wall in ms (host clock, synchronised;
    median of reps after one warm run) on the E.coli slice over n entries
    of dev, its derived budgets passed.  Calls every tree since the mesh
    layer has."""
    import torch

    from darwin_tpu_torch.parallel.mesh import make_mesh
    from darwin_tpu_torch.pipeline import collect_calls_table_sharded

    params, genome, table, merged, _, _ = _ecoli_seed_inputs()
    mesh = make_mesh(devices=[dev] * n)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collect_calls_table_sharded(table, genome, merged, params, mesh,
                                    budgets=ecoli_budgets(n),
                                    exchange=exchange)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run()
    return statistics.median(run() for _ in range(reps))


def _checking(kernel, plain, calls: list):
    """A step for dsoft_table_sharded(steps=...) that runs kernel and its
    plain version on the same inputs, fails unless they are equal
    (tolerance 0), records (args, kwargs, output) in calls and returns
    the kernel's output."""
    def step(*args, **kw):
        got = kernel(*args, **kw)
        if not _same(got, plain(*args, **kw)):
            raise AssertionError(f"{kernel.__name__} differs from its plain "
                                 f"version")
        calls.append((args, kw, got))
        return got
    return step


def phase_mesh(dev, counters: dict, want: str) -> tuple:
    """Phase 9, the mesh and multi-host layer on the one card, mesh
    entries all cuda:0; want is the E.coli slice's records (phase 4's).
    Returns ({kernel: kernels-line numbers} of the two table-sharded
    kernels, {kernel: launches} of the main path's runs: the
    table-sharded collector on the E.coli slice)."""
    import numpy as np
    import torch

    from darwin_tpu_torch import cli, entry
    from darwin_tpu_torch.dsoft import sharded_table as st
    from darwin_tpu_torch.dsoft.device import dsoft_device_batch, sharded_dsoft
    from darwin_tpu_torch.engine.aligner import TorchTileAligner
    from darwin_tpu_torch.golden.dsoft import dsoft_scalar
    from darwin_tpu_torch.io.fasta import FastaRecord, write_fasta
    from darwin_tpu_torch.parallel.mesh import ShardedTileAligner, make_mesh
    from darwin_tpu_torch.pipeline import (collect_calls, collect_calls_device,
                                           collect_calls_table_sharded,
                                           format_records, make_merged_engine,
                                           read_banks, run_device_merged)

    params, genome, table, merged, _, _ = _ecoli_seed_inputs()
    fields = ("ref_id", "query_id", "ref_pos", "query_pos")

    def same_calls(got, exp):
        return len(got) == len(exp) and all(
            np.array_equal(getattr(got, f), getattr(exp, f)) for f in fields)

    # The main path: the table-sharded collector at mesh sizes 1 and MESH
    # under each exchange, budgets derived, launches counted.
    host = collect_calls(table, genome, merged, params)
    launches = dict.fromkeys(counters, 0)
    for n in (1, MESH):
        mesh_n = make_mesh(devices=[dev] * n)
        for exchange in ("all_to_all", "all_gather"):
            m = {}
            t0 = time.perf_counter()
            calls, got = _counted(counters, lambda: collect_calls_table_sharded(
                table, genome, merged, params, mesh_n,
                budgets=ECOLI_BUDGETS.get(n), exchange=exchange, metrics=m))
            if n not in ECOLI_BUDGETS:  # derived by this run
                ECOLI_BUDGETS[n] = table._budget_cache[1]
            b = ECOLI_BUDGETS[n]
            log(f"  collect_calls_table_sharded, mesh {n}, {exchange}: "
                f"{len(calls)} calls, dsoft_overflow_reads "
                f"{m['dsoft_overflow_reads']}, budgets tup_max {b.tup_max} "
                f"cand_max {b.cand_max} a2a_cap {b.a2a_cap} "
                f"({time.perf_counter() - t0:.1f} s, derivation included "
                f"where this process had none at this mesh size); launches "
                f"{got}")
            if not same_calls(calls, host):
                raise AssertionError(f"collect_calls_table_sharded (mesh {n},"
                                     f" {exchange}) != collect_calls")
            if not got["dsoft_shard_scan"] or not got["dsoft_shard_count"]:
                raise AssertionError("the table-sharded kernels did not "
                                     "launch on the main path")
            for k, v in got.items():
                launches[k] += v
    log(f"  derived at mesh {MESH}: {ECOLI_BUDGETS[MESH].stats}")

    # The two kernels against their plain versions: the E.coli
    # read-strands over MESH entries, each index mode and exchange, and
    # SHARDED_CASES over SHARDED_P entries; the whole function also
    # against dsoft_table_sharded_torch.
    mesh, budgets, di, shards = ecoli_sharded(str(dev))
    Qt, lt, kw = ecoli_sharded_args(dev)
    scans, counts = [], []
    steps = (_checking(st.shard_scan, st.shard_scan_torch, scans),
             _checking(st.shard_count, st.shard_count_torch, counts))
    for index in ("dense", "searchsorted"):
        for a2a in (budgets.a2a_cap, None):
            t0 = time.perf_counter()
            args = (mesh, Qt, lt, shards)
            ekw = dict(kw, a2a_cap=a2a, index=index)
            got = st.dsoft_table_sharded(*args, steps=steps, **ekw)
            if not _same(got, st.dsoft_table_sharded_torch(*args, **ekw)):
                raise AssertionError(f"dsoft_table_sharded differs from its "
                                     f"plain version: E.coli, {index}, "
                                     f"a2a_cap {a2a}")
            log(f"  table-sharded D-SOFT, E.coli {Qt.shape[0]} read-strands "
                f"over {MESH}, {index}, a2a_cap {a2a}: both kernels exact "
                f"on every shard, {int(got[2].sum())} candidates, "
                f"{int(got[3].sum())} overflowed "
                f"({time.perf_counter() - t0:.1f} s)")
    timed = (scans[0], counts[0])  # dense, all-to-all, shard 0
    forms = [0, 0, 0]  # reads counted in registers, shared, device memory

    def add_forms(calls):
        for c in calls:
            for i, v in enumerate(count_forms(c[0][2])):
                forms[i] += v
        return [sum(count_forms(c[0][2])[i] for c in calls)
                for i in range(3)]

    add_forms(counts)
    for name in SHARDED_CASES:
        mesh8, q8, l8, shards8, ckw, a2a, over, gt, reads = \
            sharded_case_args(name, dev)
        del counts[:]
        for index in ("dense", "searchsorted"):
            for a2a_cap, flagged in zip((a2a, None), over):
                args = (mesh8, q8, l8, shards8)
                ekw = dict(ckw, a2a_cap=a2a_cap, index=index)
                got = st.dsoft_table_sharded(*args, steps=steps, **ekw)
                if not _same(got, st.dsoft_table_sharded_torch(*args, **ekw)):
                    raise AssertionError(f"dsoft_table_sharded differs: "
                                         f"{name}, {index}, {a2a_cap}")
                hits, offs, cnt, ov = (x.cpu().numpy() for x in got)
                if bool(ov.any()) != flagged:
                    raise AssertionError(f"{name}: overflow {ov.any()}, "
                                         f"expected {flagged}")
                for i, r in enumerate(reads):
                    gold = dsoft_scalar(gt, r, ckw["num_seeds_cap"],
                                        ckw["threshold"],
                                        ckw["max_candidates"])
                    if not ov[i] and list(zip(
                            hits[i, :cnt[i]].tolist(),
                            offs[i, :cnt[i]].tolist())) != gold:
                        raise AssertionError(f"{name}, {index}: read {i} != "
                                             f"dsoft_scalar")
        log(f"  table-sharded D-SOFT, {name} over {SHARDED_P}: exact under "
            f"each index mode and exchange, overflow {over}, golden where "
            f"no read overflowed; read counts in registers, shared memory, "
            f"device memory: {add_forms(counts)}")
    # shard_scan alone on every shard of the first case, the reads padded
    # to each L % 4 (its vector stores take LP % 4 == 0, else a position
    # at a time), and under the dense index with fewer refine steps than
    # its widest bucket needs (the kernel's truncated search).
    mesh8, q8, l8, shards8, ckw, *_ = sharded_case_args(
        next(iter(SHARDED_CASES)), dev)
    nsteps = ckw["dense_steps"]
    runs = [(pad, index, nsteps) for pad in range(4)
            for index in ("dense", "searchsorted")]
    runs += [(0, "dense", s) for s in range(nsteps)]
    for pad, index, s in runs:
        qp = torch.nn.functional.pad(q8, (0, pad))
        skw = dict(k=ckw["k"], w=ckw["w"], index=index, dense_steps=s)
        for th, _, di in shards8:
            if not _same(st.shard_scan(qp, l8, th, di, **skw),
                         st.shard_scan_torch(qp, l8, th, di, **skw)):
                raise AssertionError(f"shard_scan differs at L = "
                                     f"{qp.shape[1]}, {index}, {s} steps")
    log(f"  shard_scan on every shard, L = {q8.shape[1]} .. "
        f"{q8.shape[1] + 3}, each index mode, and dense with 0 .. {nsteps} "
        f"refine steps: exact")
    # shard_count's synthetic cases: reads at each form's edges and past
    # the shared-memory budget.
    for name in SHARD_COUNT_CASES:
        args, ckw = shard_count_case_args(name, dev)
        got = st.shard_count(*args, **ckw)
        if not _same(got, st.shard_count_torch(*args, **ckw)):
            raise AssertionError(f"shard_count differs: {name}")
        log(f"  shard_count, {name}: exact; reads in registers, shared "
            f"memory, device memory: "
            f"{add_forms([(args, ckw, got)])}; counts "
            f"{got[2].tolist()}, over {got[3].long().tolist()}")
    log(f"  shard_count's reads in registers, shared memory, device "
        f"memory over phase 9's calls: {forms}")
    if not forms[2]:
        raise AssertionError("shard_count's device-memory form never ran")
    if not forms[1] or not forms[0]:
        raise AssertionError(f"a shard_count form never ran: {forms}")

    res = {}
    for name, (args, skw, out), kernel, plain in (
            ("dsoft_shard_scan", timed[0], st.shard_scan, st.shard_scan_torch),
            ("dsoft_shard_count", timed[1], st.shard_count,
             st.shard_count_torch)):
        r = res[name] = {"max_abs_err": 0, "library_ms": None}
        r["ms"] = median_ms(lambda: kernel(*args, **skw), 20)
        r["plain_ms"] = median_ms(lambda: plain(*args, **skw), 3)
        r["device_ms"] = graph_ms(lambda: kernel(*args, **skw), n=10)
        if name == "dsoft_shard_scan":
            r.update(shard_scan_bound(args, skw, out))
            shape = (f"R={args[0].shape[0]} L={args[0].shape[1]}, "
                     f"{int(out[0].sum())} lookups")
        else:
            r.update(shard_count_bound(args, out))
            shape = (f"{args[2].shape[0] - 1} reads, "
                     f"{int(args[2][-1] - args[2][0])} tuples")
        log(f"  {name}, E.coli shard 0 of {MESH} ({shape}, dense, "
            f"all-to-all): kernel {r['ms']:.4f} ms (graph "
            f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    # Where the collector's time goes, E.coli over MESH, budgets derived.
    kernels = MESH * sum(res[k]["device_ms"] for k in res)
    for exchange, a2a in (("all_to_all", budgets.a2a_cap),
                          ("all_gather", None)):
        steps_ms = sharded_step_ms((mesh, Qt, lt, shards),
                                   dict(kw, a2a_cap=a2a, index="dense"))
        wall = collect_ms(dev, MESH, exchange)
        log(f"  collect_calls_table_sharded, E.coli over {MESH}, {exchange}:"
            f" wall {wall:.4f} ms (host clock, median of 5); "
            f"dsoft_table_sharded's steps (CUDA events at each step's end, "
            f"median of 5): " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in steps_ms.items())
            + f" ms; the two kernels' device time x {MESH} {kernels:.4f} ms")

    # The read-sharded D-SOFT over MESH against one call.
    args, dkw = ecoli_dsoft_inputs(dev, "twolevel")
    one = dsoft_device_batch(*args, **dkw)
    got = sharded_dsoft(mesh, args[0], args[1], [args[2]] * MESH,
                        [args[3]] * MESH, **dkw)
    if not _same(got, one):
        raise AssertionError("sharded_dsoft != one dsoft_device_batch call")
    if not same_calls(collect_calls_device(table, genome, merged, params,
                                           mesh=mesh), host):
        raise AssertionError("collect_calls_device(mesh=) != collect_calls")
    log(f"  sharded_dsoft over {MESH}: equal to one dsoft_device_batch call; "
        f"collect_calls_device(mesh=) equal to collect_calls")

    # The sharded tile aligner at B_MAIN, T_MAIN.
    rng = np.random.default_rng(9)
    tiles = (*related_tiles(rng, B_MAIN, T_MAIN), rng.random(B_MAIN) < 0.5)
    akw = dict(early_terminate=dict(TILES)[T_MAIN], match=1, mismatch=-1,
               gap_open=-1, gap_extend=-1, tile_size=T_MAIN)
    got = ShardedTileAligner(mesh, **akw)(*tiles)
    exp = TorchTileAligner(device=dev, **akw)(*tiles)
    for f in ("ops", "ref_steps", "query_steps", "score", "max_i", "max_j"):
        if not np.array_equal(getattr(got, f), getattr(exp, f)):
            raise AssertionError(f"ShardedTileAligner differs: {f}")
    log(f"  ShardedTileAligner over {MESH} at B={B_MAIN} T={T_MAIN}: equal "
        f"to TorchTileAligner")

    # The sharded engine on the E.coli slice's calls.
    reads = [FastaRecord([n], s) for n, s in ecoli_reads()]
    fwd, rev = read_banks(reads)
    want_lines = want.splitlines()
    for mesh_arg in (None, mesh):
        prebuilt = make_merged_engine(genome, fwd, rev, params, same_file=True,
                                      batch_size=512, device=dev,
                                      mesh=mesh_arg)
        m = {}
        (recs, _), got = _counted(counters, lambda: run_device_merged(
            genome, table, fwd, rev, params, same_file=True, batch_size=512,
            prebuilt=prebuilt, metrics=m))
        lines = sorted(set(format_records(genome, reads, recs)))
        what = (f"ShardedGactEngine over {MESH}" if mesh_arg
                else "DeviceGactEngine")
        log(f"  {what}, E.coli: {len(lines)} records, align_s "
            f"{m['align_s']:.4f}, engine iterations {m['engine_iters']}, "
            f"launches {got}")
        if lines != want_lines:
            raise AssertionError(f"{what}: E.coli records differ")
        if got["fetch_tiles"] != m["engine_iters"] or not got["traceback"]:
            raise AssertionError(f"{what}: fetch_tiles launched "
                                 f"{got['fetch_tiles']} times in "
                                 f"{m['engine_iters']} iterations")

    # The CLI: --mesh 1 in process, --mesh 2 (one card: must fail) and
    # --distributed as two processes on cuda:0.
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        fa = td / "reads.fasta"
        write_fasta(fa, ecoli_reads())
        out = td / "mesh1"
        if cli.main([str(fa), str(fa), "--params", str(td / "params.cfg"),
                     "--batch-size", "512", "--mesh", "1", "--out-dir",
                     str(out), "--merged-out", str(out / "merged")]) != 0:
            raise AssertionError("cli --mesh 1 failed")
        if (out / "merged").read_text() != want:
            raise AssertionError("cli --mesh 1: --merged-out differs from "
                                 "phase 4's")
        log("  cli --mesh 1, E.coli: --merged-out equal to phase 4's")
        r = subprocess.run(
            [sys.executable, "-m", "darwin_tpu_torch.cli", str(fa), str(fa),
             "--mesh", "2", "--out-dir", str(td / "mesh2")],
            capture_output=True, text=True, timeout=300, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=str(REPO)))
        err = r.stderr.strip().splitlines()[-1:] or [""]
        log(f"  cli --mesh 2 on one card: exit {r.returncode}, {err[0]}")
        if r.returncode == 0 or "1 visible" not in r.stderr:
            raise AssertionError("cli --mesh 2 did not fail with make_mesh's "
                                 "error")
        small = DATA / "small"
        one = td / "small1"
        if cli.main([str(small / "reads.fasta"), str(small / "reads.fasta"),
                     "--params", str(small / "params.cfg"), "--batch-size",
                     "64", "--out-dir", str(one), "--merged-out",
                     str(one / "merged")]) != 0:
            raise AssertionError("cli on small failed")
        for tag, fasta, extra, exp in (
                ("small", small / "reads.fasta",
                 ["--params", str(small / "params.cfg"), "--batch-size", "64"],
                 (one / "merged").read_text()),
                ("E.coli", fa, ["--params", str(td / "params.cfg"),
                                "--batch-size", "512", "--seed-table",
                                str(td / "table.npz")], want)):
            t0 = time.perf_counter()
            d = td / f"dist_{tag}"
            outs = distributed_cli(fasta, extra, d)
            merged_out = [(d / f"merged.{r}").read_text() for r in range(2)]
            union = sorted({ln for r in range(2) for ln in
                            (d / f"darwin.{r}.out").read_text().splitlines()})
            log(f"  cli --distributed, {tag}, two processes on {dev}: "
                f"{len(merged_out[0].splitlines())} merged records "
                f"({time.perf_counter() - t0:.1f} s); "
                + "; ".join(ln for o in outs for ln in o.splitlines()
                            if ln.startswith(("distributed:", "Seed table"))))
            if not (merged_out[0] == merged_out[1] == exp
                    == "".join(ln + "\n" for ln in union)):
                raise AssertionError(f"cli --distributed ({tag}): merged "
                                     f"outputs differ")
    t0 = time.perf_counter()
    entry.dryrun_multichip(MESH, devices=[dev] * MESH)
    log(f"  dryrun_multichip({MESH}) took {time.perf_counter() - t0:.1f} s")
    return res, launches


def distributed_cli(fasta: Path, extra: list, out: Path) -> list:
    """The port's CLI on fasta (self-overlap) with --distributed as two
    processes of one gloo group on 127.0.0.1 (a free port), writing to
    out (merged.<rank> the --merged-out); returns their standard outputs.
    Fails unless both exit 0 within 300 s; kills both otherwise."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "darwin_tpu_torch.cli", str(fasta), str(fasta),
         *extra, "--distributed", "--out-dir", str(out), "--merged-out",
         str(out / f"merged.{r}")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port, WORLD_SIZE="2", RANK=str(r)))
        for r in range(2)]
    res = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"cli --distributed exited "
                                     f"{p.returncode}:\n{e[-3000:]}")
            res.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return res


def _digest(outs) -> str:
    """sha256 (16 hex digits) of a kernel's outputs: a tensor, a tuple of
    them or a dict of them in key order."""
    if isinstance(outs, dict):
        outs = [outs[k] for k in sorted(outs)]
    elif not isinstance(outs, (tuple, list)):
        outs = [outs]
    h = hashlib.sha256()
    for t in outs:
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def checked_digests(dev, small: bool = False) -> dict:
    """{case: digest of its outputs} of phase 2's inputs through the
    library _build.CHECKED selects: the DP in three formats and plane 2
    at every TILES entry and scoring, each walker on the DP's output and
    on walk_cases, the span fetch (pair and one set) at every TILES
    entry on both bank ends, SW on phase 2's pairs and at its tiling's
    edges, the walkers at LARGE_ET (large_et_walks), both scan
    lowerings at B = 2048, C = 384 and at SCAN_WIDTHS, the D-SOFT kernel
    on dsoft_cases under each index mode and on the E.coli read-strands
    (R = 920 and 9200), and the table-sharded D-SOFT's two kernels on
    SHARDED_CASES and the E.coli read-strands (phase 9's inputs) under
    each index mode and exchange, shard_scan on the first case's first
    shard at the other three L % 4 and with one refine step, and
    shard_count on SHARD_COUNT_CASES.
    small: B = 36, the tile size 64 and
    one scoring, one large-ET walk, the scans at C = 33 and 1024 beside
    the probe's shape, the D-SOFT cases under the two-level index only,
    the table-sharded cases under the dense index only and no E.coli
    batch.
    On the checked library each case's name goes to stderr before it
    runs, so that a trap names it."""
    import numpy as np
    import torch

    from darwin_tpu_torch.dsoft.device import dsoft_device_batch
    from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF
    from darwin_tpu_torch.ops.dp import PACKERS, align_tiles
    from darwin_tpu_torch.ops.plane2 import plane2
    from darwin_tpu_torch.ops.swscore import local_score_batch
    from darwin_tpu_torch.ops.tile_fetch import fetch_tile_pair, fetch_tiles
    from darwin_tpu_torch.ops.traceback import WALKERS as WALK_FNS

    B = 36 if small else B_MAIN
    tiles = TILES[1:2] if small else TILES
    scorings = SCORINGS[:1] if small else SCORINGS
    res = {}

    from darwin_tpu_torch import _build

    def run(case, fn):
        if _build.CHECKED:  # a trap ends the run: name its case first
            print(f"checked: {case}", file=sys.stderr, flush=True)
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        res[case] = _digest(out)
        return out

    rng, wrng = np.random.default_rng(0), np.random.default_rng(1)
    for T, ET in tiles:
        ref, query, rlen, qlen = (torch.from_numpy(x).to(dev) for x in
                                  related_tiles(rng, B, T))
        first = torch.from_numpy(rng.random(B) < 0.5).to(dev)
        for sc in scorings:
            kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                          sc))
            for fmt, (key, walk) in WALK_FNS.items():
                out = run(f"align_tiles[{fmt}] T={T} {sc}",
                          lambda: align_tiles(ref, query, rlen, qlen,
                                              dir_format=fmt, **kw))
                args = (out[key], rlen, qlen, first, out["max_i"],
                        out["max_j"])
                run(f"{WALKERS[fmt]} T={T} {sc}",
                    lambda: walk(*args, early_terminate=ET))
            run(f"plane2 T={T} {sc}",
                lambda: plane2(ref, query, rlen, qlen, **kw))
        dirm, *rest = (torch.from_numpy(x).to(dev)
                       for x in walk_case_batch(wrng, T, B))
        for fmt, (_, walk) in WALK_FNS.items():
            packer = PACKERS[fmt]
            args = (dirm if packer is None else packer(dirm), *rest)
            run(f"{WALKERS[fmt]} T={T} walk_cases",
                lambda: walk(*args, early_terminate=ET))

    frng = np.random.default_rng(2)
    gbank, qbank = fetch_banks(frng, dev)
    for T, _ in TILES:
        g_start, rl = fetch_spans(frng, gbank.shape[0], T, dev)
        q_start, ql = fetch_spans(frng, qbank.shape[0], T, dev)
        back = torch.from_numpy(frng.random(B_MAIN) < 0.5).to(dev)
        if small and T != tiles[0][0]:
            continue
        run(f"fetch_tile_pair T={T}", lambda: fetch_tile_pair(
            gbank, qbank, g_start, q_start, rl, ql, back, T=T,
            pad_ref=PAD_REF, pad_query=PAD_QUERY))
        for name, bank, start, length, pad in (
                ("genome", gbank, g_start, rl, PAD_REF),
                ("reads", qbank, q_start, ql, PAD_QUERY)):
            run(f"fetch_tiles {name} T={T}", lambda: fetch_tiles(
                bank, start, length, back, T=T, pad=pad))

    sw = [torch.from_numpy(x).to(dev)
          for x in sw_pairs(np.random.default_rng(3), SW_B, SW_LEN)]
    erng = np.random.default_rng(4)
    shapes = [(f"LR={LR} LQ={LQ}", [torch.from_numpy(x).to(dev) for x in
                                     sw_edge_pairs(erng, SW_B, LR, LQ)])
              for LR, LQ in sw_edge_shapes()]
    for tag, pairs in ([] if small else [("pairs", sw)]) + shapes:
        for sc in scorings:
            kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                          sc))
            run(f"local_score_batch {tag} {sc}",
                lambda: local_score_batch(*pairs, **kw))

    for case, fmt, args, ET in large_et_walks(dev)[:1 if small else None]:
        run(case, lambda: WALK_FNS[fmt][1](*args, early_terminate=ET))
    from darwin_tpu_torch.lab.scanshift_probe import probe_inputs
    from darwin_tpu_torch.ops.scanshift import scanshift_shfl, scanshift_smem

    scans = [("B=2048 C=384", torch.from_numpy(
        probe_inputs(1, 2048, 376)[0][0]).to(dev))]
    scans += [(f"B={SCAN_EDGE_B} C={C}", scan_edge_input(C, dev))
              for C in ((33, 1024) if small else SCAN_WIDTHS)]
    for tag, x in scans:
        for fn in (scanshift_shfl, scanshift_smem):
            run(f"{fn.__name__} {tag}", lambda: fn(x))
    modes = ("twolevel",) if small else ("twolevel", "searchsorted", "dense")
    for name, gt, reads, ckw in dsoft_cases():
        for index in modes:
            args, kw = dsoft_case_args(gt, reads, ckw, index, dev)
            run(f"dsoft_device {name} {index}",
                lambda: dsoft_device_batch(*args, **kw))
    if not small:
        args, kw = ecoli_dsoft_inputs(dev, "twolevel")
        run("dsoft_device E.coli twolevel",
            lambda: dsoft_device_batch(*args, **kw))
        big = ecoli_x10(args)
        run("dsoft_device E.coli x10 twolevel",
            lambda: dsoft_device_batch(*big, **kw))
    # The table-sharded D-SOFT's kernels (through dsoft_table_sharded):
    # SHARDED_CASES over SHARDED_P entries and the E.coli read-strands
    # over MESH, each index mode and exchange.
    from darwin_tpu_torch.dsoft.sharded_table import (dsoft_table_sharded,
                                                      shard_count, shard_scan)

    sharded = []
    for name in SHARDED_CASES:
        mesh8, q8, l8, shards8, ckw, a2a, *_ = sharded_case_args(name, dev)
        sharded.append((name, (mesh8, q8, l8, shards8), ckw, a2a))
    if not small:
        mesh, budgets, _, shards = ecoli_sharded(str(dev))
        Qt, lt, ekw = ecoli_sharded_args(dev)
        sharded.append(("E.coli", (mesh, Qt, lt, shards), ekw,
                        budgets.a2a_cap))
    for name, args, skw, a2a in sharded:
        for index in ("dense",) if small else ("dense", "searchsorted"):
            for cap in (a2a, None):
                run(f"dsoft_sharded {name} {index} a2a_cap={cap}",
                    lambda: dsoft_table_sharded(*args, a2a_cap=cap,
                                                index=index, **skw))
    # shard_scan's stores a position at a time (L % 4 != 0) and its
    # truncated two-level search (fewer refine steps than a bucket needs)
    # on the first case's first shard, and shard_count's synthetic cases
    # (every form).
    _, (_, q8, l8, shards8), ckw, _ = sharded[0]
    th, _, di = shards8[0]
    runs = [(pad, index, ckw["dense_steps"]) for pad in (1, 2, 3)
            for index in (("dense",) if small else ("dense", "searchsorted"))]
    for pad, index, steps in runs + [(0, "dense", 1)]:
        qp = torch.nn.functional.pad(q8, (0, pad))
        run(f"shard_scan L={qp.shape[1]} {index} steps={steps}",
            lambda: shard_scan(qp, l8, th, di, k=ckw["k"], w=ckw["w"],
                               index=index, dense_steps=steps))
    for name in SHARD_COUNT_CASES:
        args, kw = shard_count_case_args(name, dev)
        run(f"shard_count {name}", lambda: shard_count(*args, **kw))
    return res


def checked_trap(dev) -> None:
    """The checked library's control: one walker launch told B = 4 over
    tensors of two tiles (the wrapper's checks bypassed), which reads
    and writes past its allocations and must trap."""
    import torch

    from darwin_tpu_torch import _build

    T = 8
    d = torch.zeros((2, T, T + 1), dtype=torch.uint8, device=dev)
    n = torch.full((2,), T, dtype=torch.int32, device=dev)
    raw = torch.empty((2, 2 * T - 1), dtype=torch.uint8, device=dev)
    _build.launch("dtt_traceback", dev, d, n, n, n.bool(), n, n, 4, T, T,
                  raw, n.clone(), n.clone())
    torch.cuda.synchronize()


def _checked_child(*flags) -> subprocess.CompletedProcess:
    """This script with --checked and flags, in a child process."""
    return subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--checked", *flags], capture_output=True,
                          text=True, timeout=900, cwd=REPO)


# PyTorch's message for cudaErrorLaunchFailure, the error a kernel's
# __trap() leaves on its context, and the line a --trap child prints when
# its launch did not trap.
TRAP_ERROR = "CUDA error: unspecified launch failure"
NO_TRAP = "checked_trap: no trap"


def trapped(r: subprocess.CompletedProcess) -> bool:
    """Whether a `--checked --trap` child ended in the launch failure of
    a trap, not in another error (a failed build, an exception before
    the launch) nor after a launch that did not trap."""
    return (r.returncode != 0 and TRAP_ERROR in r.stderr
            and NO_TRAP not in r.stderr)


def phase_checked(dev) -> dict:
    """Phase 7: checked_trap must end a child process on the checked
    library; then checked_digests in another, against this process's on
    the normal library.  Returns {kernel: cases} run."""
    r = _checked_child("--trap")
    if not trapped(r):
        raise AssertionError(f"the checked library did not trap on an "
                             f"out-of-bounds launch (exit {r.returncode}):"
                             f"\n{r.stderr[-3000:]}")
    log(f"  control: an out-of-bounds launch ends its process in a trap "
        f"(exit {r.returncode}, \"{TRAP_ERROR}\")")
    want = checked_digests(dev)
    t0 = time.perf_counter()
    b = ecoli_budgets(MESH)
    r = _checked_child("--budgets",
                       json.dumps([b.tup_max, b.cand_max, b.a2a_cap]))
    if r.returncode != 0:
        raise AssertionError(f"the checked library's run exited "
                             f"{r.returncode}:\n{r.stderr[-3000:]}")
    got = json.loads(r.stdout.strip().splitlines()[-1])
    differ = sorted(k for k in want.keys() | got.keys()
                    if got.get(k) != want.get(k))
    if differ:
        raise AssertionError(f"checked library's outputs differ: "
                             f"{differ[:5]} ({len(differ)} cases)")
    cases = {}
    for k in want:
        name = k.split(" ")[0].split("[")[0]
        cases[name] = cases.get(name, 0) + 1
    log(f"  {len(want)} cases, no trap, every output equal to the normal "
        f"library's ({time.perf_counter() - t0:.1f} s): {cases}")
    return cases


def phase_ab(dev, reps: int = 20) -> dict:
    """The imported tree's walkers, span fetch, SW, D-SOFT and scans on
    phase 2's inputs at T_MAIN (its first draws; first scoring): the
    byte walker and both word walkers, one fetch_tiles call, and two
    (one an engine iteration before fetch_tile_pair), SW at SW_B on
    SW_LEN-base pairs, the D-SOFT kernel on the E.coli read-strands
    (two-level index) at R = 920 and ten times over and on
    dsoft_budget_reads (its large path, arrays in shared memory at
    tup_max TUP_MAX and in device memory at 32768), and both scan
    lowerings at B = 2048, C = 384, and the table-sharded D-SOFT's
    kernels on the E.coli slice's table over MESH entries (dense index,
    all-to-all): shard_scan on shard 0 at R = 920 and ten times over,
    shard_count on shard 0's tuples; each as the median of reps
    event-timed calls (ms) and as device_ms, with each call's output
    sum and digest, which must agree between trees.  Then the same
    collector: collect_calls_table_sharded's wall (collect_ms) and
    dsoft_table_sharded's steps (sharded_step_ms, "sharded_" before each
    step's name), whose "scan" and "count" are the two kernels' part.
    Uses only calls whose signatures every version of the port since the
    table-sharded kernels' redesign has kept."""
    import numpy as np
    import torch

    from darwin_tpu_torch.dsoft import sharded_table as st
    from darwin_tpu_torch.dsoft.device import dsoft_device_batch
    from darwin_tpu_torch.lab.scanshift_probe import probe_inputs
    from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF
    from darwin_tpu_torch.ops.dp import align_tiles
    from darwin_tpu_torch.ops.scanshift import scanshift_shfl, scanshift_smem
    from darwin_tpu_torch.ops.swscore import local_score_batch
    from darwin_tpu_torch.ops.tile_fetch import fetch_tiles
    from darwin_tpu_torch.ops.traceback import (traceback, traceback_packed,
                                                 traceback_packed6)

    rng = np.random.default_rng(0)
    ref, query, rlen, qlen = (torch.from_numpy(x).to(dev) for x in
                              related_tiles(rng, B_MAIN, T_MAIN))
    first = torch.from_numpy(rng.random(B_MAIN) < 0.5).to(dev)
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                  SCORINGS[0]))
    walks = {}
    for fmt in ("bytes", "packed", "packed6"):
        out = align_tiles(ref, query, rlen, qlen, dir_format=fmt, **kw)
        walks[fmt] = (out["dir" if fmt == "bytes" else "dir_words"], rlen,
                      qlen, first, out["max_i"], out["max_j"])
    ET = dict(TILES)[T_MAIN]
    sw = [torch.from_numpy(x).to(dev)
          for x in sw_pairs(np.random.default_rng(3), SW_B, SW_LEN)]
    sw[2].fill_(SW_LEN)
    sw[3].fill_(SW_LEN)
    frng = np.random.default_rng(2)
    gbank, qbank = fetch_banks(frng, dev)
    g_start, rl = fetch_spans(frng, gbank.shape[0], T_MAIN, dev)
    q_start, ql = fetch_spans(frng, qbank.shape[0], T_MAIN, dev)
    back = torch.from_numpy(frng.random(B_MAIN) < 0.5).to(dev)
    dargs, dkw = ecoli_dsoft_inputs(dev, "twolevel")
    dbig = ecoli_x10(dargs)
    gt, breads = dsoft_budget_reads()
    budget = {t: dsoft_case_args(gt, list(breads), dict(
        threshold=18, num_seeds_cap=BUDGET_CAP, max_candidates=10**6,
        tup_max=t, cand_max=256), "twolevel", dev) for t in (TUP_MAX, 32768)}
    sx = torch.from_numpy(probe_inputs(1, 2048, 376)[0][0]).to(dev)
    calls = {
        "walker": lambda: traceback(*walks["bytes"], early_terminate=ET),
        "walker_packed": lambda: traceback_packed(*walks["packed"],
                                                  early_terminate=ET),
        "walker_packed6": lambda: traceback_packed6(*walks["packed6"],
                                                    early_terminate=ET),
        "sw": lambda: (local_score_batch(*sw, **kw),),
        "fetch_one_set": lambda: (fetch_tiles(qbank, q_start, ql, back,
                                              T=T_MAIN, pad=PAD_QUERY),),
        "fetch_two_sets": lambda: (
            fetch_tiles(gbank, g_start, rl, back, T=T_MAIN, pad=PAD_REF),
            fetch_tiles(qbank, q_start, ql, back, T=T_MAIN,
                        pad=PAD_QUERY)),
        "dsoft_920": lambda: dsoft_device_batch(*dargs, **dkw),
        "dsoft_9200": lambda: dsoft_device_batch(*dbig, **dkw),
        "dsoft_large_smem": lambda: dsoft_device_batch(
            *budget[TUP_MAX][0], **budget[TUP_MAX][1]),
        "dsoft_large_gmem": lambda: dsoft_device_batch(
            *budget[32768][0], **budget[32768][1]),
        "scan_shfl": lambda: (scanshift_shfl(sx),),
        "scan_smem": lambda: (scanshift_smem(sx),),
    }
    scan_args, scan_kw, count_args, count_kw = sharded_kernel_args(dev)
    big = (scan_args[0].repeat(10, 1), scan_args[1].repeat(10),
           *scan_args[2:])
    calls["shard_scan_920"] = lambda: st.shard_scan(*scan_args, **scan_kw)
    calls["shard_scan_9200"] = lambda: st.shard_scan(*big, **scan_kw)
    calls["shard_count"] = lambda: st.shard_count(*count_args, **count_kw)
    res = {}
    for name, fn in calls.items():
        out = fn()
        res[f"{name}_sum"] = sum(int(o.long().sum()) for o in out)
        res[f"{name}_digest"] = _digest(out)
        res[f"{name}_ms"] = median_ms(fn, reps)
        res[f"{name}_device_ms"] = graph_ms(
            fn, n=10 if name.startswith(("dsoft", "shard")) else
            GRAPH_LAUNCHES)
    mesh, budgets, _, shards = ecoli_sharded(str(dev))
    Qt, lt, skw = ecoli_sharded_args(dev)
    steps = sharded_step_ms((mesh, Qt, lt, shards),
                            dict(skw, a2a_cap=budgets.a2a_cap, index="dense"))
    res.update({f"sharded_{k}_ms": v for k, v in steps.items()})
    res["sharded_collect_ms"] = collect_ms(dev, MESH, "all_to_all")
    return res


def sharded_kernel_args(dev) -> tuple:
    """The table-sharded D-SOFT's kernel calls on the E.coli slice's table
    over MESH entries of dev (dense index, all-to-all, derived budgets):
    shard_scan's arguments and keywords on shard 0 (every read-strand),
    and shard_count's on shard 0's tuples, taken from one
    dsoft_table_sharded call."""
    from darwin_tpu_torch.dsoft import sharded_table as st

    mesh, budgets, _, shards = ecoli_sharded(str(dev))
    Qt, lt, kw = ecoli_sharded_args(dev)
    counts = []
    st.dsoft_table_sharded(mesh, Qt, lt, shards, a2a_cap=budgets.a2a_cap,
                           index="dense", steps=(st.shard_scan, _checking(
                               st.shard_count, st.shard_count_torch, counts)),
                           **kw)
    th, _, di = shards[0]
    return ((Qt, lt, th, di), dict(k=kw["k"], w=kw["w"], index="dense",
                                   dense_steps=kw["dense_steps"]),
            *counts[0][:2])


# Phase 10: the kernels the skewed drain runs (the engine in bytes) and
# the bench's step launch.
DRAIN_KERNELS = ("align_tiles", "fetch_tiles", "traceback")
BENCH_KERNELS = ("align_tiles", "traceback_packed6")
DRAIN_REPS = 3


def _tool(name: str):
    """tools/<name>.py as a module."""
    import importlib

    tools = str(REPO / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def _drain_prof():
    """tools/torch_drain_prof.py as a module."""
    return _tool("torch_drain_prof")


def phase_drain(dev, counters: dict, ecoli_drains: dict) -> dict:
    """Phase 10's drain: the gate off on the E.coli slice (phase 4's
    runs, ecoli_drains); the skewed workload of tools/torch_drain_prof.py
    under auto with the counters zeroed (the gate must engage and the
    engine re-dispatch), then off, auto and always, DRAIN_REPS warm runs
    each, one record set.  Returns {kernel: launches} of the counted
    run."""
    from darwin_tpu_torch.engine.device_batch import gate_engages

    dp = _drain_prof()
    for tag, (gate, redis) in ecoli_drains.items():
        log(f"  E.coli {tag}: gate (tail, total) {gate}, drain_redispatches "
            f"{redis}")
        if redis or (gate is not None and gate_engages(*gate)):
            raise AssertionError(f"the drain engaged on the E.coli slice "
                                 f"({tag})")
    if all(g is None for g, _ in ecoli_drains.values()):
        raise AssertionError("no E.coli run evaluated the drain's gate")
    t0 = time.perf_counter()
    genome, bank, calls = dp.skewed_workload()
    eng = dp.make_engine(genome, bank, dev)
    log(f"  skewed workload: {len(calls)} calls, made in "
        f"{time.perf_counter() - t0:.1f} s")
    recs, launches = _counted(counters,
                              lambda: eng.finish(eng.run_async(calls, False)))
    log(f"  auto, counted: gate (tail, total) {eng.last_drain_gate}, "
        f"re-dispatches {eng.last_drain_redispatches}, iterations "
        f"{eng.last_iters}, launches {launches}")
    if eng.last_drain_gate is None or not gate_engages(
            *eng.last_drain_gate):
        raise AssertionError(f"the gate did not engage on the skewed "
                             f"workload: {eng.last_drain_gate}")
    if eng.last_drain_redispatches < 1:
        raise AssertionError("auto: no re-dispatch on the skewed workload")
    idle = [k for k in DRAIN_KERNELS if launches[k] <= 0]
    if idle or launches["fetch_tiles"] != eng.last_iters:
        raise AssertionError(f"skewed auto run: {idle} not launched, or "
                             f"fetch_tiles {launches['fetch_tiles']} times "
                             f"in {eng.last_iters} iterations")
    res = dp.engine_modes(eng, calls, DRAIN_REPS)
    for mode, r in res.items():
        log(f"  {mode}: align_s median {r['align_s_median']:.4f} s of "
            f"{[round(t, 4) for t in r['align_s']]}, iterations "
            f"{r['iters']}, active slot-iterations {r['active_sum']} "
            f"(mean active/B {r['mean_active_over_B']:.4f}), re-dispatches "
            f"{r['redispatches']}, records {len(r['records'])}")
    want = dp.record_set(recs)
    bad = [m for m, r in res.items() if r["records"] != want]
    if bad or not want:
        raise AssertionError(f"drain modes {bad} give another record set")
    if (res["auto"]["redispatches"] < 1 or res["always"]["redispatches"] < 1
            or res["off"]["redispatches"]):
        raise AssertionError("re-dispatches: off must have none, auto and "
                             "always at least one")
    off, auto = res["off"]["align_s_median"], res["auto"]["align_s_median"]
    log(f"  align_s auto / off: {auto / off:.4f}")
    return launches


def bench_bound(B: int, T: int) -> str:
    """The bounds of one bench step at B full T x T tiles: the DP alone
    (tiles and lengths in, packed6 words [B, T, T+1] int32 and four
    int32 stats a tile out; DP_OPS_CELL a cell) and the whole step,
    whose outputs are the walker's (the words stay on the card: an op
    byte a step up to 2T steps, two int32 step counts and the stats a
    tile)."""
    cells = B * T * T
    tiles_in = 2 * B * T + 2 * 4 * B
    dp = bound(tiles_in + 4 * B * T * (T + 1) + 16 * B,
               DP_OPS_CELL * cells)
    step = bound(tiles_in + B * 2 * T + 8 * B + 16 * B,
                 DP_OPS_CELL * cells)
    return (f"DP {dp['bound_ms']:.4f} ms ({dp['bound_by']}), step "
            f"{step['bound_ms']:.4f} ms ({step['bound_by']}), "
            f"{cells / step['bound_ms'] / 1e6:.1f} GCUPS at the bound")


def phase_bench(dev) -> tuple:
    """Phase 10's bench: one batch's step sink at T = 376 against the
    plain versions', then darwin_tpu_torch.bench at full size in a child
    process.  Returns (its JSON line, {kernel: launches} it reports)."""
    import torch

    from darwin_tpu_torch import bench
    from darwin_tpu_torch.lab import wrap32

    b = bench.Batches(dev, bench.B, bench.T, 1)
    got = wrap32(int(bench.one_step(b, 0, bench.ET)))
    want = wrap32(int(bench.one_step(b, 0, bench.ET, plain=True)))
    log(f"  step sink at B={bench.B}, T={bench.T}, ET={bench.ET}: kernels "
        f"{got}, plain versions {want}")
    if got != want:
        raise AssertionError("bench step sink differs from the plain "
                             "versions'")
    del b
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "darwin_tpu_torch.bench"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    for line in r.stderr.strip().splitlines()[-6:]:
        log("  bench: " + line)
    if r.returncode != 0:
        raise AssertionError(f"darwin_tpu_torch.bench exited {r.returncode}")
    lines = r.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    log(f"  bench took {time.perf_counter() - t0:.1f} s")
    if len(lines) != 1 or not out["value"] > 0:
        raise AssertionError(f"bench printed {lines}")
    launches = json.loads(next(ln for ln in r.stderr.splitlines()
                               if ln.startswith("launches: "))[10:])
    for t, et in bench.GEOMETRIES:
        log(f"  bench bound at B={bench.B}, T={t}: " + bench_bound(bench.B, t))
    idle = [k for k in BENCH_KERNELS if launches.get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"bench: {idle} not launched")
    return lines[-1], launches


# Phase 11: tests/data/guided_shape's dataset, as tools/torch_scale_test.py
# makes it from these flags (its README gives the JAX tool's command),
# and the bigcoord run just past 2^31 bases, every piece but the last N.
GUIDED_SHAPE_FLAGS = ("--guided", "--chromosomes", "4", "--genome", "4600000",
                      "--reads", "4600", "--read-len", "10000", "--error",
                      "0.12", "--seed", "42")
BIGCOORD_FLAGS = ("--gb", "2.06", "--pieces", "40", "--filler", "N",
                  "--engine", "device")
SCALE_KERNELS = ("align_tiles", "traceback", "fetch_tiles")
RESIDENT_REPS = 3


def _launched(tag: str, launches: dict, iters=None, extra=()) -> None:
    """Fails unless SCALE_KERNELS and extra launched in a run and, where
    its engine iterations are given, the span fetch once an iteration."""
    idle = [k for k in (*SCALE_KERNELS, *extra) if launches[k] <= 0]
    if idle or iters not in (None, launches["fetch_tiles"]):
        raise AssertionError(f"{tag}: {idle} not launched, or fetch_tiles "
                             f"{launches['fetch_tiles']} times in {iters} "
                             f"engine iterations")


def guided_shape_digests() -> dict:
    """{file: sha256} of tests/data/guided_shape/dataset.sha256."""
    lines = (DATA / "guided_shape" / "dataset.sha256").read_text()
    return {f: h for h, f in (ln.split() for ln in lines.splitlines())}


def bigcoord_kernel_checks(b: dict, params, dev) -> None:
    """The span fetch and the D-SOFT kernel against their plain versions
    on a bigcoord build's inputs: tiles fetched from its genome bank past
    2^31 bytes (spans at the reads' origins in the last piece, at random
    in it and at the bank's end), and its reads' strands seeded from
    its table, whose positions are uint32 lanes past 2^31 (at least one
    hit must lie in the last piece, which starts past 2^31)."""
    import numpy as np
    import torch

    from darwin_tpu_torch.dsoft.device import (dsoft_device_batch,
                                               dsoft_device_batch_torch,
                                               pad_reads)
    from darwin_tpu_torch.engine.device_batch import device_banks
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.ops.common import PAD_QUERY, PAD_REF
    from darwin_tpu_torch.ops.tile_fetch import (fetch_tile_pair,
                                                 fetch_tile_pair_torch)
    from darwin_tpu_torch.pipeline import _index_on

    bc = _tool("torch_bigcoord_dryrun")
    genome, table, reads = b["genome"], b["table"], b["reads"]
    strands = SeqBank([*reads, *(bc.revcomp_codes(r) for r in reads)])
    gbank, qbank = device_banks(genome, strands, dev)
    n = gbank.shape[0]
    B, T = 512, params.tile_size
    rng = np.random.default_rng(2031)
    last = int(genome.chr_id_to_start_bin[-1]) * genome.bin_size
    g = np.concatenate([
        last + np.repeat(b["origins"], B // 4 // len(reads))
        + rng.integers(-T, T, size=B // 4 // len(reads) * len(reads)),
        rng.integers(last, n, size=B // 2),
        n - rng.integers(-T, 2 * T, size=B // 4)])
    g = np.resize(g, B)
    rl = rng.integers(0, T + 1, size=B, dtype=np.int32)
    ql = rng.integers(0, T + 1, size=B, dtype=np.int32)
    q = rng.integers(0, qbank.shape[0], size=B)
    spans = [torch.from_numpy(x).to(dev) for x in (g, q, rl, ql)]
    back = torch.from_numpy(rng.random(B) < 0.5).to(dev)
    kw = dict(T=T, pad_ref=PAD_REF, pad_query=PAD_QUERY)
    got = fetch_tile_pair(gbank, qbank, *spans, back, **kw)
    want = fetch_tile_pair_torch(gbank, qbank, *spans, back, **kw)
    if not _same(got, want):
        raise AssertionError("fetch_tile_pair differs from its plain "
                             "version on the bank past 2^31")
    log(f"  fetch_tile_pair on the {n}-byte bank, spans from "
        f"{int(g.min())} to {int(g.max())}: exact (B = {B}, T = {T})")
    del gbank, qbank

    th, tpos, steps = _index_on(table, "twolevel", dev)
    Q, lens = pad_reads(strands, range(len(strands.lengths)))
    args = (torch.from_numpy(Q).to(dev), torch.from_numpy(lens).to(dev),
            th, tpos)
    kw = dict(k=table.k, w=table.w, bin_size=table.bin_size,
              kmer_max_occ=table.kmer_max_occurence,
              num_seeds_cap=params.num_seeds, threshold=params.threshold,
              max_candidates=params.max_candidates, tup_max=TUP_MAX,
              cand_max=CAND_MAX, index="twolevel", tl_steps=steps)
    got = dsoft_device_batch(*args, **kw)
    if not _same(got, dsoft_device_batch_torch(*args, **kw)):
        raise AssertionError("dsoft_device differs from its plain version "
                             "on the table past 2^31")
    hits, counts = got[0].cpu().numpy(), got[2].cpu().numpy()
    top = max((int(hits[i, :c].max()) for i, c in enumerate(counts) if c),
              default=0)
    log(f"  dsoft_device on {len(counts)} read-strands against the "
        f"{len(table.pos)}-entry table: exact, {int(counts.sum())} "
        f"candidates, the largest hit {top} ({top / 2**31:.4f} x 2^31)")
    if not top > last:
        raise AssertionError("no D-SOFT hit in the last piece")


def phase_scale(dev, counters: dict, ecoli_want: str) -> dict:
    """Phase 11: guided_shape through the device engine under each
    D-SOFT, resident serving on the E.coli slice, the bigcoord run past
    2^31; each run with the counters zeroed just before it.  Returns
    {kernel: launches} summed over the runs."""
    import torch

    from darwin_tpu_torch.config import Params
    from darwin_tpu_torch.io.fasta import FastaRecord

    st = _tool("torch_scale_test")
    rs = _tool("torch_resident_serve")
    bc = _tool("torch_bigcoord_dryrun")
    mu = _tool("torch_mem_usage")
    total = dict.fromkeys(counters, 0)

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    want = (DATA / "guided_shape" / "jax_cpu.darwin").read_text().splitlines()
    with tempfile.TemporaryDirectory() as td:
        args = st.parse_args([*GUIDED_SHAPE_FLAGS, "--workdir", td])
        t0 = time.perf_counter()
        st.make_dataset(args, Path(td))
        got = {f: hashlib.sha256((Path(td) / f).read_bytes()).hexdigest()
               for f in ("genome.fasta", "reads.fasta")}
        log(f"  guided_shape made in {time.perf_counter() - t0:.1f} s: "
            f"{got}")
        if got != guided_shape_digests():
            raise AssertionError(f"guided_shape digests {got} != "
                                 f"{guided_shape_digests()}")
        for dsoft in ("host", "device"):
            args = st.parse_args([*GUIDED_SHAPE_FLAGS, "--dsoft", dsoft,
                                  "--warm", "0", "--workdir", td])
            out, launches = _counted(counters, lambda: st.run(args))
            log(f"  guided_shape, device engine, {dsoft} D-SOFT: records "
                f"{out['records']} (expected {len(want)}), wall "
                f"{out['cold_s']:.3f} s, seed table {out['table_s']:.3f} s, "
                f"seed_s {out['seed_s']:.3f}, align_s {out['align_s']:.3f}, "
                f"reads/s {out['reads_per_s']:.1f} (over seed_s + align_s "
                f"{out['reads_per_s_seed_align']:.1f}), sensitivity "
                f"{out['sensitivity']:.6f}, specificity "
                f"{out['specificity']:.6f}; launches {launches}")
            if out["records_list"] != want:
                w, g = set(want), set(out["records_list"])
                raise AssertionError(
                    f"guided_shape records differ ({dsoft} D-SOFT): missing "
                    f"{sorted(w - g)[:3]} extra {sorted(g - w)[:3]}")
            _launched(f"guided_shape {dsoft}", launches, out["engine_iters"],
                      ("dsoft_device",) if dsoft == "device" else ())
            add(launches)

    torch.cuda.reset_peak_memory_stats(dev)
    recs = [FastaRecord([n], s) for n, s in ecoli_reads()]
    res, launches = _counted(counters, lambda: rs.serve(
        recs, recs, Params(), same_file=True, reps=RESIDENT_REPS,
        batch_size=512, device=dev, log=lambda s: log("  resident: " + s)))
    ecoli = ecoli_want.splitlines()
    bad = [i for i, b in enumerate(res["batches"]) if b["records"] != ecoli]
    if bad or res["first"] != ecoli or len(res["batches"]) != RESIDENT_REPS:
        raise AssertionError(f"resident batches {bad} (or the first) differ "
                             f"from phase 4's records")
    log(f"  resident serving, E.coli slice: {RESIDENT_REPS} batches and the "
        f"first equal to phase 4's records; launches {launches}; "
        + mu.memory_line(dev))
    _launched("resident serving", launches)
    add(launches)

    torch.cuda.reset_peak_memory_stats(dev)
    params = Params()
    args = bc.parse_args(list(BIGCOORD_FLAGS))
    t0 = time.perf_counter()
    b = bc.build(args, params, log=lambda s: log("  bigcoord: " + s))
    log(f"  bigcoord build: {time.perf_counter() - t0:.1f} s")
    if not b["big"]:
        raise AssertionError(f"{BIGCOORD_FLAGS}: not past 2^31")
    bigcoord_kernel_checks(b, params, dev)
    for dsoft in ("host", "device"):
        t0 = time.perf_counter()
        _, launches = _counted(counters, lambda: bc.remap(
            b, params, engine="device", dsoft=dsoft, batch=args.batch,
            device=dev, log=lambda s: log("  bigcoord: " + s)))
        log(f"  bigcoord, device engine, {dsoft} D-SOFT: every read re-maps "
            f"past 2^31 ({time.perf_counter() - t0:.1f} s); launches "
            f"{launches}")
        _launched(f"bigcoord {dsoft}", launches,
                  extra=("dsoft_device",) if dsoft == "device" else ())
        add(launches)
    log("  " + mu.memory_line(dev))
    return total


def run_phases(dev, golden_pool) -> tuple:
    """Phases 1 (the build) to 11, phase 8's golden spec computed by
    golden_pool; returns the kernels line's numbers and launches, the
    main paths' first, then the lab's."""
    from darwin_tpu_torch import _build
    from darwin_tpu_torch.dsoft import sharded_table as st
    from darwin_tpu_torch.dsoft.device import dsoft_device_batch
    from darwin_tpu_torch.ops import traceback as tb
    from darwin_tpu_torch.ops.dp import align_tiles
    from darwin_tpu_torch.ops.tile_fetch import fetch_tiles

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        checked = pool.submit(_build.build, True)
        report = _build.build()
        checked.result()
    _build.lib()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s -> {_build.LIB} "
        f"and {_build.LIB_CHECKED.name}")
    for line in _registers(report):
        log("  " + line)

    log("[2/11] kernels against their plain versions (tolerance 0)")
    kres = phase_kernels(dev)
    kres["dsoft_device"], plain_overflow = phase_dsoft(dev)
    golden = golden_soak_start(golden_pool)
    log("[3/11] fixtures against the reference binary's out.darwin, both "
        "engines, and the device engine with --dsoft device")
    t0 = time.perf_counter()
    phase_fixtures(dev)
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")
    log("[4/11] E.coli-shaped slice: device engine in each tb_format, host "
        "engine, device engine with --dsoft device")
    counters = {"align_tiles": align_tiles, "traceback": tb.traceback,
                "traceback_packed": tb.traceback_packed,
                "traceback_packed6": tb.traceback_packed6,
                "fetch_tiles": fetch_tiles,
                "dsoft_device": dsoft_device_batch,
                "dsoft_shard_scan": st.shard_scan,
                "dsoft_shard_count": st.shard_count}
    ecoli_drains: dict = {}
    launches = phase_ecoli(dev, counters, plain_overflow, ecoli_drains)
    log("[5/11] kernel lab (darwin_tpu_torch.lab), then each lab kernel "
        "against its plain version")
    t0 = time.perf_counter()
    lres, llaunches = phase_lab(dev)
    log(f"  phase 5 took {time.perf_counter() - t0:.1f} s")
    log("[6/11] score evaluator (darwin_tpu_torch.eval.score_eval)")
    launches["local_score_batch"] = phase_scoreeval(dev)
    log("[7/11] phase 2's inputs through the checked library, in a child "
        "process")
    phase_checked(dev)
    log("[8/11] golden soak: tests/test_fuzz_pipeline.py's pinned instances "
        "on the card against the golden spec")
    t0 = time.perf_counter()
    phase_golden(dev, golden)
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s")
    log("[9/11] mesh and multi-host: the table-sharded D-SOFT's kernels, "
        "the sharded D-SOFT, aligner and engine on a mesh of cuda:0 "
        "entries, the CLI's --mesh and --distributed, entry.py's "
        "dryrun")
    t0 = time.perf_counter()
    mres, mlaunches = phase_mesh(
        dev, counters, (DATA / "ecoli_shape" / "jax_cpu.darwin").read_text())
    for k in ("dsoft_shard_scan", "dsoft_shard_count"):
        kres[k] = mres[k]
        launches[k] = mlaunches[k]
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    log("[10/11] drain and bench: the gate off on the E.coli slice, the "
        "skewed workload under drain off, auto and always, "
        "darwin_tpu_torch.bench at full size")
    t0 = time.perf_counter()
    dlaunches = phase_drain(dev, counters, ecoli_drains)
    bench_line, blaunches = phase_bench(dev)
    print(bench_line, flush=True)
    log(f"  launches: skewed auto run {dlaunches}, bench {blaunches}")
    for part in (dlaunches, blaunches):
        for k, n in part.items():
            launches[k] += n
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    log("[11/11] scale and serving: guided_shape (4 chromosomes, 10x the "
        "E.coli slice's reads) under each D-SOFT, resident serving, the "
        "bigcoord run past 2^31")
    t0 = time.perf_counter()
    slaunches = phase_scale(
        dev, counters, (DATA / "ecoli_shape" / "jax_cpu.darwin").read_text())
    log(f"  launches: {slaunches}")
    for k, n in slaunches.items():
        launches[k] += n
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    # The main paths' numbers first; the lab's for the kernels only the
    # lab runs.
    for k, v in lres.items():
        kres.setdefault(k, v)
    for k, v in llaunches.items():
        launches.setdefault(k, v)
    return kres, launches


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="time only this tree's walkers, fetch, "
                    "SW, D-SOFT and scans (phase_ab)")
    ap.add_argument("--checked", action="store_true",
                    help="print checked_digests of the checked library "
                         "(phase 7's child)")
    ap.add_argument("--small", action="store_true",
                    help="with --checked: one small input a kernel")
    ap.add_argument("--trap", action="store_true",
                    help="with --checked: run checked_trap instead")
    ap.add_argument("--budgets", help="with --checked: the E.coli slice's "
                    "budgets at mesh size MESH, [tup_max, cand_max, "
                    "a2a_cap] in JSON")
    ap.add_argument("--index-modes", action="store_true",
                    help="time only collect_calls_device cold and warm "
                         "under each index mode (seed_times)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    root = Path(args.root).resolve() if args.root else REPO
    sys.path.insert(0, str(root))
    from darwin_tpu_torch import _build

    dev = torch.device("cuda", 0)
    if args.checked:
        _build.CHECKED = True
        if args.budgets:
            from darwin_tpu_torch.dsoft.sharded_table import ShardedBudgets

            ECOLI_BUDGETS[MESH] = ShardedBudgets(*json.loads(args.budgets),
                                                 stats={})
        if args.trap:
            checked_trap(dev)
            print(NO_TRAP, file=sys.stderr)
            return 0
        print(json.dumps(checked_digests(dev, small=args.small)))
        return 0
    smi = nvidia_smi_line()
    if args.root:
        if not Path(_build.__file__).resolve().is_relative_to(root):
            raise AssertionError(f"imported {_build.__file__}, not {root}'s")
        report = _build.build()
        _build.lib()
        print(json.dumps({"root": str(root), "device": smi,
                          "registers": _registers(report),
                          **phase_ab(dev)}))
        return 0
    if args.index_modes:
        print(json.dumps({"device": smi, **seed_times(dev)}))
        return 0
    log(f"[1/11] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    # Phase 8's golden spec runs on the host's cores from phase 3 on
    # (after phase 2's timings), in spawned processes (no CUDA state is
    # forked).
    golden_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        kres, launches = run_phases(dev, golden_pool)
    finally:
        golden_pool.shutdown(wait=True, cancel_futures=True)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **kres[name])
               for name, (src, rep, _) in KERNELS.items()]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on their path: {idle}")
    short = [k["name"] for k in kernels if not KERNEL_KEYS <= k.keys()]
    if short:
        raise AssertionError(f"kernels line incomplete for {short}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
