"""Randomized soak of the PyTorch port against its golden scalar spec.

The port's counterpart of tools/fuzz_soak.py: random small instances
(randomized scoring, tile geometry, D-SOFT knobs, error rates, N bases,
reverse complements; de novo, or --guided against 1-3 chromosomes) from
the port's copies of tests/test_fuzz_pipeline.py's generators
(_instance, _guided_instance: the same params and reads for the same
seed), each run through darwin_tpu_torch.pipeline.run_pipeline on
--device and through darwin_tpu_torch.golden.pipeline.golden_pipeline;
the record sets must be equal.  For every instance the device D-SOFT's
calls (pipeline.collect_calls_device on --device, over both strands)
must also equal the host D-SOFT's (collect_calls) as a set.  Stops at
the first mismatch with a repro line.  Imports no JAX.

Usage: python tools/torch_fuzz_soak.py START COUNT [--guided]
           [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from darwin_tpu_torch.config import Params  # noqa: E402
from darwin_tpu_torch.io.fasta import FastaRecord  # noqa: E402

ALPHA = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP = {65: 84, 84: 65, 67: 71, 71: 67, 78: 78}
# The seeds tests/test_fuzz_pipeline.py pins: de novo, then guided.
PINNED = [101, 202, 303, 404, 505, 7032]
PINNED_GUIDED = [606, 707, 808]


def _instance(seed):
    """A de novo instance: (Params, reads), the reads named
    R<i>_<pos>_<len> (tests/test_fuzz_pipeline.py:22)."""
    rng = np.random.default_rng(seed)
    params = Params(
        match=int(rng.integers(1, 4)),
        mismatch=-int(rng.integers(1, 5)),
        gap_open=-int(rng.integers(1, 6)),
        gap_extend=-int(rng.integers(1, 4)),
        seed_size=int(rng.choice([11, 12, 13])),
        bin_size=int(rng.choice([32, 64, 128])),
        window_size=int(rng.choice([3, 4, 5])),
        threshold=int(rng.integers(11, 20)),
        num_seeds=int(rng.choice([50, 300, 800])),
        first_tile_score_threshold=int(rng.integers(5, 30)),
        tile_size=int(rng.choice([48, 64, 96])),
        tile_overlap=int(rng.choice([16, 24, 32])),
    )
    glen = int(rng.integers(4000, 12000))
    n_frac = float(rng.choice([0.0, 0.02]))
    p = [(1 - n_frac) / 4] * 4 + [n_frac]
    genome = rng.choice(ALPHA, size=glen, p=p).astype(np.uint8)
    reads = []
    n_reads = int(rng.integers(4, 9))
    for i in range(n_reads):
        s = int(rng.integers(0, max(1, glen - 1500)))
        length = int(rng.integers(300, 1500))
        r = genome[s:s + length].copy()
        err = float(rng.choice([0.0, 0.05, 0.12]))
        mut = rng.random(len(r)) < err
        r[mut] = rng.choice(ALPHA[:4], size=int(mut.sum()))
        if rng.random() < 0.3:
            r = np.array([_COMP[c] for c in r[::-1]], dtype=np.uint8)
        reads.append(FastaRecord([f"R{i}_{s}_{len(r)}"],
                                 r.tobytes().decode()))
    return params, reads


def _guided_instance(seed):
    """A guided instance: (Params, chromosomes, reads)
    (tests/test_fuzz_pipeline.py:73)."""
    rng = np.random.default_rng(seed)
    params, _ = _instance(seed)  # reuse the randomized parameter draw
    n_chrom = int(rng.integers(1, 4))
    chroms = []
    for c in range(n_chrom):
        glen = int(rng.integers(2000, 8000))
        seq = rng.choice(ALPHA[:4], size=glen).astype(np.uint8)
        chroms.append(FastaRecord([f"chr{c}"], seq.tobytes().decode()))
    reads = []
    for i in range(int(rng.integers(3, 7))):
        src = chroms[int(rng.integers(0, n_chrom))]
        g = np.frombuffer(src.seq.encode(), dtype=np.uint8)
        s = int(rng.integers(0, max(1, len(g) - 1200)))
        r = g[s:s + int(rng.integers(400, 1200))].copy()
        mut = rng.random(len(r)) < float(rng.choice([0.0, 0.08]))
        r[mut] = rng.choice(ALPHA[:4], size=int(mut.sum()))
        if rng.random() < 0.4:
            r = np.array([_COMP[c] for c in r[::-1]], dtype=np.uint8)
        reads.append(FastaRecord([f"Q{i}"], r.tobytes().decode()))
    return params, chroms, reads


def instance(seed: int, guided: bool):
    """(params, reference records, reads, same_file, batch_size) of one
    instance, as tests/test_fuzz_pipeline.py runs it."""
    if guided:
        params, chroms, reads = _guided_instance(seed)
        return params, chroms, reads, False, 16
    params, reads = _instance(seed)
    bs = int(np.random.default_rng(seed).choice([8, 32, 64]))
    return params, reads, reads, True, bs


def golden_records(seed: int, guided: bool) -> set:
    """The golden spec's record set of one instance (numpy only, so it
    may run in a worker process)."""
    from darwin_tpu_torch.golden.pipeline import golden_pipeline

    params, ref, reads, same_file, _ = instance(seed, guided)
    return set(golden_pipeline(ref, reads, params, same_file=same_file))


def check(seed: int, guided: bool, device, want: set | None = None) -> str:
    """'' when the port's records on device equal the golden spec's
    (want, computed here when None) and its device D-SOFT's calls equal
    the host D-SOFT's; else what differs."""
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.index.genome import Genome
    from darwin_tpu_torch.index.seed_table import SeedTable
    from darwin_tpu_torch.pipeline import (collect_calls,
                                           collect_calls_device, read_banks,
                                           run_pipeline)

    params, ref, reads, same_file, bs = instance(seed, guided)
    if want is None:
        want = golden_records(seed, guided)
    got = set(run_pipeline(ref, reads, params, same_file, batch_size=bs,
                           device=device).records)
    if got != want:
        return (f"records: params {params} missing "
                f"{sorted(want - got)[:3]} extra {sorted(got - want)[:3]}")
    genome = Genome(ref, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size)
    bank = SeqBank.concat(*read_banks(reads))

    def calls(c):
        return sorted(zip(*(getattr(c, f).tolist() for f in (
            "ref_id", "query_id", "ref_pos", "query_pos"))))

    host = calls(collect_calls(table, genome, bank, params))
    dev = calls(collect_calls_device(table, genome, bank, params,
                                     device=device))
    if dev != host:
        return (f"calls: {len(dev)} from the device D-SOFT, {len(host)} "
                f"from the host's; first differing "
                f"{sorted(set(dev) ^ set(host))[:3]}")
    return ""


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("start", type=int)
    ap.add_argument("count", type=int)
    ap.add_argument("--guided", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device is available",
              file=sys.stderr)
        return 2
    t0 = time.time()
    for n, seed in enumerate(range(args.start, args.start + args.count)):
        bad = check(seed, args.guided, device)
        if bad:
            print(f"MISMATCH seed={seed} guided={args.guided} {bad}",
                  flush=True)
            return 1
        if (n + 1) % 10 == 0:
            print(f"{n + 1}/{args.count} exact ({time.time() - t0:.0f} s)",
                  flush=True)
    print(f"SOAK OK: {args.count} instances exact (seeds {args.start}-"
          f"{args.start + args.count - 1}, guided={args.guided}, device "
          f"{device}, {time.time() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
