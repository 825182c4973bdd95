"""The port's table-sharded D-SOFT at a given genome size, held to the
native host D-SOFT.

The counterpart of tools/sharded_scale.py.  A random reference of
--genome bases, its seed table, and --reads reads of --read-len bases at
--error substitutions; derive_budgets sizes tup_max, cand_max and
a2a_cap from the workload (safety x the observed maxima), the table is
split into hash-range shards with their two-level dense index, and
dsoft_table_sharded runs over a mesh of --entries entries of --device
(cuda:0 by default: the kernels of csrc/dsoft_sharded.cu; cpu: their
plain versions) under both exchanges, all-gather and all-to-all.  Every
read's candidates must equal the native host D-SOFT's (the port's
library, darwin_tpu's dtnative) with no read overflowed.  Prints the
budgets and their statistics, each exchange's cold and warm time,
overflow count, parity and received bytes an entry, the peak host RSS
and device memory; --json writes the same.

Usage: python tools/torch_sharded_scale.py [--genome 4600000] [--reads 64]
           [--read-len 10000] [--entries 8] [--device cuda|cpu]
           [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import darwin_tpu_torch  # noqa: F401,E402  (THP madvise guard)
import numpy as np  # noqa: E402

CHUNK = 1 << 27  # bases drawn at a time: bounds the generator's memory


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--genome", type=int, default=4_600_000)
    p.add_argument("--reads", type=int, default=64)
    p.add_argument("--read-len", type=int, default=10_000)
    p.add_argument("--error", type=float, default=0.12)
    p.add_argument("--entries", type=int, default=8)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--safety", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    return p.parse_args(argv)


def workload(args):
    """(reference bytes, reads): a random reference drawn CHUNK bases at
    a time and args.reads reads sampled from it with args.error
    substitutions, numpy seed args.seed."""
    rng = np.random.default_rng(args.seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = np.empty(args.genome, dtype=np.uint8)
    for lo in range(0, args.genome, CHUNK):
        n = min(CHUNK, args.genome - lo)
        ref[lo:lo + n] = alpha[rng.integers(0, 4, size=n, dtype=np.uint8)]
    reads = []
    L = args.read_len
    for _ in range(args.reads):
        s = int(rng.integers(0, args.genome - L))
        r = ref[s:s + L].copy()
        mut = rng.random(L) < args.error
        r[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
        reads.append(r)
    return ref, reads


def run(args, params, log=print) -> dict:
    """The budgets, the shards and both exchanges on the mesh; returns
    the summary that --json writes, with "ok"."""
    import torch

    from darwin_tpu_torch import native
    from darwin_tpu_torch.dsoft.device import pad_reads
    from darwin_tpu_torch.dsoft.sharded_table import (
        derive_budgets, dsoft_table_sharded, make_sharded_dense_index,
        make_sharded_table, place_shards)
    from darwin_tpu_torch.engine.seqbank import SeqBank
    from darwin_tpu_torch.index.seed_table import SeedTable
    from darwin_tpu_torch.lab import resolve_device
    from darwin_tpu_torch.parallel.mesh import make_mesh
    from torch_mem_usage import host_memory_line, peak_device_gb, peak_rss_gb

    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    P = args.entries
    log(host_memory_line())
    t0 = time.perf_counter()
    ref, reads = workload(args)
    log(f"workload: {args.genome} bp reference, {args.reads} x "
        f"{args.read_len} bp reads ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    table = SeedTable.build(ref, params.seed_size,
                            params.seed_occurence_multiple, params.bin_size,
                            params.window_size)
    log(f"table: {len(table.pos)} entries ({time.perf_counter() - t0:.1f} "
        f"s), kmer_max_occ={table.kmer_max_occurence}")
    del ref

    t0 = time.perf_counter()
    bud = derive_budgets(table, reads, P, num_seeds_cap=params.num_seeds,
                         threshold=params.threshold,
                         max_candidates=params.max_candidates,
                         safety=args.safety)
    t_derive = time.perf_counter() - t0
    log(f"derive_budgets ({t_derive:.1f} s): tup_max={bud.tup_max} "
        f"cand_max={bud.cand_max} a2a_cap={bud.a2a_cap}")
    for k, v in bud.stats.items():
        log(f"  {k}: {v}")

    mesh = make_mesh(devices=[device] * P)
    t0 = time.perf_counter()
    hs, ps = make_sharded_table(table.hashes, table.pos, P)
    di = make_sharded_dense_index(hs)
    t_shard = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = place_shards(mesh, hs, ps, di)
    t_place = time.perf_counter() - t0
    steps = di.steps
    log(f"shards: [{P}, {hs.shape[1]}] entries, two-level index "
        f"steps={steps} ({t_shard:.1f} s), placed on {P} x {device} "
        f"({t_place:.1f} s)")
    del hs, ps, di

    bank = SeqBank(reads)
    R = len(reads)
    t0 = time.perf_counter()
    counts, hits, offs = native.dsoft_batch(
        table.hashes, table.pos, table.k, table.w, table.bin_size,
        table.ref_size, table.kmer_max_occurence, bank.flat, bank.starts,
        bank.lengths, np.arange(R, dtype=np.int64), params.num_seeds,
        params.threshold, params.max_candidates)
    t_host = time.perf_counter() - t0
    ends = np.cumsum(counts)
    oracle = [list(zip(hits[e - c:e].tolist(), offs[e - c:e].tolist()))
              for c, e in zip(counts, ends)]
    log(f"native host D-SOFT: {int(counts.sum())} candidates "
        f"({t_host:.2f} s)")

    Q, lens = pad_reads(bank, range(R))
    RM = -(-R // P) * P
    Q = torch.from_numpy(np.pad(Q, ((0, RM - R), (0, 0))))
    lens = torch.from_numpy(np.pad(lens, (0, RM - R)))
    kw = dict(k=table.k, w=table.w, bin_size=table.bin_size,
              kmer_max_occ=table.kmer_max_occurence,
              num_seeds_cap=params.num_seeds, threshold=params.threshold,
              max_candidates=params.max_candidates, tup_max=bud.tup_max,
              cand_max=bud.cand_max, index="dense", dense_steps=steps)

    def call(cap):
        out = dsoft_table_sharded(mesh, Q, lens, shards, a2a_cap=cap, **kw)
        return [x[:R].cpu().numpy() for x in out]

    results = {}
    for mode, cap in (("all_gather", None), ("all_to_all", bud.a2a_cap)):
        t0 = time.perf_counter()
        h, o, c, over = call(cap)
        t_cold = time.perf_counter() - t0
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            h, o, c, over = call(cap)
        t_warm = (time.perf_counter() - t0) / reps
        mism = sum(1 for i in range(R)
                   if over[i] or list(zip(h[i, :c[i]].tolist(),
                                          o[i, :c[i]].tolist())) != oracle[i])
        traffic = P * (bud.tup_max if cap is None else cap) * 3 * 4
        results[mode] = dict(warm_s=t_warm, cold_s=t_cold,
                             overflow=int(over.sum()),
                             mismatching_reads=mism,
                             recv_bytes_per_entry=traffic)
        log(f"{mode}: warm {t_warm:.4f} s/batch (cold {t_cold:.3f}), "
            f"overflow {int(over.sum())}/{R}, parity "
            f"{'EXACT' if mism == 0 and not over.any() else 'FAIL'}, recv "
            f"{traffic / 1e6:.1f} MB an entry")
    self_gb, _ = peak_rss_gb()
    out = dict(genome=args.genome, reads=R, read_len=args.read_len,
               entries=P, device=str(device), table_entries=len(table.pos),
               budgets=dict(tup_max=bud.tup_max, cand_max=bud.cand_max,
                            a2a_cap=bud.a2a_cap),
               stats=bud.stats, derive_s=t_derive, shard_s=t_shard,
               place_s=t_place, host_dsoft_s=t_host, results=results,
               peak_rss_gb=self_gb, peak_device_gb=peak_device_gb(device))
    out["ok"] = all(r["mismatching_reads"] == 0 and r["overflow"] == 0
                    for r in results.values())
    log(f"peak RSS {self_gb:.2f} GB, peak device memory "
        f"{out['peak_device_gb']}")
    return out


def main(argv=None) -> int:
    from darwin_tpu_torch.config import Params

    args = parse_args(argv)
    out = run(args, Params(), log=lambda s: print(s, flush=True))
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    print("PARITY: EXACT" if out["ok"] else "PARITY: FAILED")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
