"""Where a block of the device D-SOFT kernel, or of the table-sharded
D-SOFT's two kernels, spends its time.

    python tools/torch_dsoft_phases.py [--sharded]     (needs a CUDA card)

Copies darwin_tpu_torch into a temporary directory, adds clock64 stamps
at the phase boundaries of the copy's dsoft_small (csrc/dsoft.cu: the
scan and its lookups, the tuples, the sort, the per-bin counts, the
output) and a globaltimer stamp at each block's start and end, builds
the copy and runs it on chip_smoke's E.coli read-strands (R = 920,
two-level index, tup_max 8192).  Prints each phase's SM cycles a block
(median, mean, p90, max), the blocks' start and end times (the waves),
the scan's cycles by chunks scanned, and the instrumented kernel's
device time (chip_smoke.graph_ms).

With --sharded it stamps the copy's csrc/dsoft_sharded.cu instead:
shard_scan's phases a chunk (the next chunk's loads, the hashes, the
window minima, the anchor's max scan, the lookups, the staging and the
chunk's end barrier, the stores), summed over a block's chunks, and
count_small's (the loads, the keys and their sort, the per-bin counts,
the output), each as seen by a block's thread 0 and averaged over the
blocks, on chip_smoke.sharded_kernel_args' E.coli shard 0 of 4 (R =
920, dense index; shard 0's tuples).  The repository's kernels are not
touched; the stamps cost a few instructions a phase.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
NSLOT = 8  # clock64 at 6 boundaries, globaltimer at start and end
MAX_BLOCKS = 1024

# (text of csrc/dsoft.cu, what replaces it): each must occur once.
PATCHES = [
    ("#include \"dsoft_common.cuh\"\n\nnamespace {\n",
     "#include \"dsoft_common.cuh\"\n\n"
     "__device__ long long g_phase[%d * %d];\n\n"
     "namespace {\n\n"
     "__device__ __forceinline__ long long gtime() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n"
     "}\n"
     "#define STAMP(i, v) \\\n"
     "  if (threadIdx.x == 0 && blockIdx.x < %d) \\\n"
     "    g_phase[blockIdx.x * %d + (i)] = (v);\n"
     % (MAX_BLOCKS, NSLOT, MAX_BLOCKS, NSLOT)),
    ("  scan_read<INDEX, NTS, PPS, false>(P, r, lim, ixbase, ixshift, kpos, "
     "kstart,\n                                    kcumb, S, &total, "
     "&nkept);\n",
     "  STAMP(6, gtime())\n  STAMP(0, clock64())\n"
     "  scan_read<INDEX, NTS, PPS, false>(P, r, lim, ixbase, ixshift, kpos, "
     "kstart,\n                                    kcumb, S, &total, "
     "&nkept);\n  STAMP(1, clock64())\n"),
    ("  __syncthreads();\n\n  // 4. Sort by (bin, t)",
     "  __syncthreads();\n  STAMP(2, clock64())\n\n  // 4. Sort by (bin, t)"),
    ("  sort_keys<NTS, ES>(x, p2, sk);\n",
     "  sort_keys<NTS, ES>(x, p2, sk);\n  STAMP(3, clock64())\n"),
    ("  write_out<NTS, false>(P, r, n_t, total, s_fc, s_hit, s_off, "
     "S.sh[1]);\n",
     "  STAMP(4, clock64())\n"
     "  write_out<NTS, false>(P, r, n_t, total, s_fc, s_hit, s_off, "
     "S.sh[1]);\n  STAMP(5, clock64())\n  STAMP(7, gtime())\n"),
]
READER = """
extern "C" int dtt_dsoft_phases(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));
}
"""
PHASES = ("scan", "tuples", "sort", "counts", "out")

# csrc/dsoft_sharded.cu's stamps: PH(i) adds the cycles since the last
# stamp to slot i (thread 0 of each block).
SHARDED_PHASES = {0: "scan: next chunk's loads", 1: "scan: hashes",
                  2: "scan: window minima", 3: "scan: anchor max scan",
                  4: "scan: lookups", 5: "scan: staging, end barrier",
                  6: "scan: stores", 8: "count: loads",
                  9: "count: keys and sort", 10: "count: per-bin counts",
                  11: "count: output"}
SHARDED_PATCHES = [
    ("namespace {\n\n// shard_scan's threads a block",
     "__device__ unsigned long long g_ph[16];\n"
     "#define PH(i) \\\n"
     "  if (threadIdx.x == 0) { \\\n"
     "    const long long t_ = clock64(); \\\n"
     "    atomicAdd(&g_ph[i], static_cast<unsigned long long>(t_ - t0_)); \\\n"
     "    t0_ = t_; \\\n"
     "  }\n\n"
     "namespace {\n\n// shard_scan's threads a block"),
    ("  int anchor = 0;  // the last change point before the chunk "
     "(virtual 0)\n",
     "  int anchor = 0;  // the last change point before the chunk "
     "(virtual 0)\n  long long t0_ = clock64();\n"),
    ("      if (next) load_chunk<NTH>(q, qend, cs + CH - w, win, pre);\n",
     "      if (next) load_chunk<NTH>(q, qend, cs + CH - w, win, pre);\n"
     "      PH(0)\n"),
    ("      __syncthreads();\n      // mm[i]:",
     "      __syncthreads();\n      PH(1)\n      // mm[i]:"),
    ("      bool inr[PP], chg[PP];\n",
     "      PH(2)\n      bool inr[PP], chg[PP];\n"),
    ("      anchor = max(anchor, last);\n",
     "      anchor = max(anchor, last);\n      PH(3)\n"),
    ("      lookup_multi<INDEX, PP>(ix, ixbase, ixshift, m, em, st, en);\n",
     "      lookup_multi<INDEX, PP>(ix, ixbase, ixshift, m, em, st, en);\n"
     "      PH(4)\n"),
    ("      __syncthreads();  // this chunk's readers of code, s_hash, sh "
     "are done\n",
     "      __syncthreads();  // this chunk's readers of code, s_hash, sh "
     "are done\n      PH(5)\n"),
    ("          at(occ, row + p0 + e) = en[e] - st[e];\n        }\n      }\n"
     "    }\n",
     "          at(occ, row + p0 + e) = en[e] - st[e];\n        }\n      }\n"
     "    }\n    PH(6)\n"),
    ("  if (n > kRegTuples) return;\n",
     "  if (n > kRegTuples) return;\n  long long t0_ = clock64();\n"),
    ("  __syncthreads();\n  unsigned long long x[ES];\n",
     "  __syncthreads();\n  PH(8)\n  unsigned long long x[ES];\n"),
    ("    sort_keys<NTH, ES>(x, p2, s_keys);\n  }\n",
     "    sort_keys<NTH, ES>(x, p2, s_keys);\n  }\n  PH(9)\n"),
    ("                                          P.threshold, sh[0]);\n"
     "  __syncthreads();\n",
     "                                          P.threshold, sh[0]);\n"
     "  __syncthreads();\n  PH(10)\n"),
    ("  count_out<NTH, false, false>(P, r, n, s_fc, s_hit, s_off, sh[1]);\n",
     "  count_out<NTH, false, false>(P, r, n, s_fc, s_hit, s_off, sh[1]);\n"
     "  PH(11)\n"),
]
SHARDED_READER = """
extern "C" int dtt_shard_phases(unsigned long long* out) {
  const cudaError_t e = cudaMemcpyFromSymbol(out, g_ph, sizeof(g_ph));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[16] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_ph, zero, sizeof(g_ph)));
}
"""


def instrument(src: str, patches=PATCHES, reader=READER,
               name: str = "csrc/dsoft.cu") -> str:
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{name} changed: {old[:50]!r} is not there "
                               f"once")
        src = src.replace(old, new)
    return src + reader


def quantiles(v, qs) -> list:
    import numpy as np

    return [round(float(np.percentile(v, q)), 2) for q in qs]


def sharded(td: str) -> int:
    """--sharded: shard_scan's and count_small's phases."""
    import torch

    import chip_smoke as cs
    from darwin_tpu_torch import _build
    from darwin_tpu_torch.dsoft import sharded_table as st

    if not Path(_build.__file__).resolve().is_relative_to(Path(td)):
        raise AssertionError(f"imported {_build.__file__}")
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line())
    lib = _build.lib()
    scan_args, scan_kw, count_args, count_kw = cs.sharded_kernel_args(dev)
    buf = (ctypes.c_ulonglong * 16)()
    for what, fn, blocks in (
            ("shard_scan", lambda: st.shard_scan(*scan_args, **scan_kw),
             scan_args[0].shape[0]),
            ("shard_count", lambda: st.shard_count(*count_args, **count_kw),
             count_args[2].shape[0] - 1)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        if lib.dtt_shard_phases(buf) != 0:  # reset
            raise RuntimeError("dtt_shard_phases failed")
        fn()
        torch.cuda.synchronize()
        if lib.dtt_shard_phases(buf) != 0:
            raise RuntimeError("dtt_shard_phases failed")
        cycles = {name: buf[i] / blocks for i, name in SHARDED_PHASES.items()
                  if name.startswith(what[6:])}
        print(f"{what}, {blocks} blocks: SM cycles a block (thread 0), "
              f"total {sum(cycles.values()):.0f}: "
              + ", ".join(f"{k} {v:.0f}" for k, v in cycles.items()))
        print(f"  instrumented {what}: device "
              f"{cs.graph_ms(fn, n=10):.4f} ms")
    return 0


def main() -> int:
    with tempfile.TemporaryDirectory() as td:
        pkg = Path(td) / "darwin_tpu_torch"
        shutil.copytree(REPO / "darwin_tpu_torch", pkg,
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        if "--sharded" in sys.argv[1:]:
            cu = pkg / "csrc" / "dsoft_sharded.cu"
            cu.write_text(instrument(cu.read_text(), SHARDED_PATCHES,
                                     SHARDED_READER, "csrc/dsoft_sharded.cu"))
        else:
            cu = pkg / "csrc" / "dsoft.cu"
            cu.write_text(instrument(cu.read_text()))
        sys.path[:0] = [td, str(REPO)]
        if "--sharded" in sys.argv[1:]:
            import torch

            if not torch.cuda.is_available():
                print("torch_dsoft_phases: needs a CUDA card",
                      file=sys.stderr)
                return 1
            return sharded(td)
        import numpy as np
        import torch

        import chip_smoke as cs
        from darwin_tpu_torch import _build
        from darwin_tpu_torch.dsoft.device import dsoft_device_batch

        if not torch.cuda.is_available():
            print("torch_dsoft_phases: needs a CUDA card", file=sys.stderr)
            return 1
        if not Path(_build.__file__).resolve().is_relative_to(Path(td)):
            raise AssertionError(f"imported {_build.__file__}")
        dev = torch.device("cuda", 0)
        print(cs.nvidia_smi_line())
        lib = _build.lib()
        args, kw = cs.ecoli_dsoft_inputs(dev, "twolevel")
        R = args[0].shape[0]
        for _ in range(3):
            dsoft_device_batch(*args, **kw)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (MAX_BLOCKS * NSLOT))()
        if lib.dtt_dsoft_phases(buf) != 0:
            raise RuntimeError("dtt_dsoft_phases failed")
        a = np.frombuffer(buf, dtype=np.int64).reshape(
            MAX_BLOCKS, NSLOT)[:min(R, MAX_BLOCKS)]
        d = np.diff(a[:, :6], axis=1)
        for i, name in enumerate(PHASES):
            v = d[:, i]
            print(f"{name:7s} cycles a block: median {np.median(v):.0f}, "
                  f"mean {v.mean():.0f}, p90 {np.percentile(v, 90):.0f}, "
                  f"max {v.max()}")
        tot = a[:, 5] - a[:, 0]
        print(f"block cycles: median {np.median(tot):.0f}, max {tot.max()}")
        t0 = a[:, 6].min()
        print(f"kernel span {(a[:, 7].max() - t0) / 1e3:.2f} us, block wall "
              f"median {np.median(a[:, 7] - a[:, 6]) / 1e3:.2f} us")
        qs = (0, 25, 50, 75, 90, 100)
        print("block starts, us:", quantiles((a[:, 6] - t0) / 1e3, qs))
        print("block ends, us:", quantiles((a[:, 7] - t0) / 1e3, qs))
        # Chunks scanned: the scan stops after the chunk holding the
        # num_seeds cap's rank or the tuple total past tup_max.
        st = cs._dsoft_steps(args, kw)
        cap1 = kw["num_seeds_cap"] + 1
        last = ((st["passing"] & (st["rank"] == cap1))
                | (st["keep"] & (st["cum"] > kw["tup_max"])))
        hi = 16 * ((args[1].long() + 15) // 16) - kw["k"] - kw["w"]
        stop = torch.minimum(torch.where(last, st["pos"], st["LP"]).min(
            dim=1).values, hi - 1)
        lo = kw["w"] - 1
        chunks = ((stop - lo).clamp(min=-1) // 1024 + 1).cpu().numpy()
        for c in sorted(set(chunks.tolist())):
            sel = chunks == c
            print(f"{c} chunks: {int(sel.sum())} read-strands, scan median "
                  f"{np.median(d[sel, 0]):.0f} cycles")
        tuples = st["cum"][:, -1].clamp(max=kw["tup_max"]).cpu().numpy()
        big = tuples > 512
        print(f"sort median: {np.median(d[big, 2]):.0f} cycles at 513-1024 "
              f"tuples ({int(big.sum())} read-strands), "
              f"{np.median(d[~big, 2]):.0f} below")
        ms = cs.graph_ms(lambda: dsoft_device_batch(*args, **kw), n=10)
        print(f"instrumented kernel: device {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
