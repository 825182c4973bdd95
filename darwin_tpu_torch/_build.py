"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by nvcc for sm_90a, one nvcc process per
source, all started together (the native host library's C++ source lives
in ``native_src/``, which native.py builds with g++), and the objects
are linked into one shared library, ``_build/libdtt_kernels.so``, with a
plain C interface that is bound with ctypes.  The build happens at first
use (never at import) and again whenever a source or header in csrc/ is
newer than the library.  Each C entry launches on the stream it is given
and returns ``cudaGetLastError()``; ``launch`` raises if that is not 0.

The checked library, ``_build/libdtt_kernels_checked.so``, is the same
sources built with ``-DDTT_CHECKED`` (csrc/checked.cuh): every global
load and store of the kernels traps when it falls outside the
allocation it addresses.  ``launch`` takes it instead of the normal
one while ``CHECKED`` is true (``chip_smoke.py --checked`` sets it), and
hands the kernels each tensor argument's storage extent first.  A trap ends the process's CUDA context: run the checked
library in a process of its own (``python3 chip_smoke.py --checked``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_DIR = Path(__file__).resolve().parent
CSRC = _DIR / "csrc"
LIB = _DIR / "_build" / "libdtt_kernels.so"
LIB_CHECKED = _DIR / "_build" / "libdtt_kernels_checked.so"
# Whether launch() takes the checked library.
CHECKED = False
# -Xptxas -v reports registers / shared memory / spills per kernel;
# build() returns that report.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures (see the csrc files); the last argument is the stream.
_SIGNATURES = {
    "dtt_align_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # ref, query, ref_len, query_len, B, T, scoring, fmt, interleave,
    # strips, width, dir, dir2, the four stats.
    "dtt_align_tiles16": [_P, _P, _P, _P, *[_I] * 10, *[_P] * 7],
    "dtt_traceback": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _P, _P, _P, _P],
    # nsets, then two sets of (bank, n, n_read, start, len, pad, out).
    "dtt_fetch_tiles": [_I, *[_P, _L, _L, _P, _P, _I, _P] * 2,
                        _P, _I, _I, _P],
    "dtt_scanshift": [_P, _I, _I, _I, _I, _P, _P],
    "dtt_traceback_words": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P],
    "dtt_local_score": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P],
    # queries, qlens, R, L, the index (h, csr, bkt, base, shift, nh, nb,
    # steps), table_pos, D-SOFT's nine ints, index mode, the card's SMs,
    # scratch, the four outputs.
    "dtt_dsoft": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                  *[_I] * 9, _I, _I, _P, _P, _P, _P, _P, _P],
    # queries, qlens, R, L, LP, the shard's index (h, crs, bkt, base,
    # shift, nh, nb, steps), k, w, index mode, emit, start, occ.
    "dtt_shard_scan": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _P, _P, _P, _P],
    # hit, off, seg, R, N, k, bin_size, threshold, max_candidates,
    # cand_max, the card's SMs, scratch, the four outputs.
    "dtt_shard_count": [_P, _P, _P, _I, _L, *[_I] * 6, _P, _P, _P, _P, _P,
                        _P],
    # bases, n, k, w, meta (then out_hash, out_pos for the emit).
    "dtt_seed_count": [_P, _L, _I, _I, _P, _P],
    "dtt_seed_emit": [_P, _L, _I, _I, _P, _P, _P, _P],
    # hash, pos, hash2, pos2, n, bits, scratch.
    "dtt_radix_sort": [_P, _P, _P, _P, _L, _I, _P, _P],
    # cs, calls, assign, ctl, records, offs, lens, flags, N, B, T,
    # gap_diff, same_file, compute_score.
    "dtt_slot_prepare": [*[_P] * 8, *[_I] * 6, _P],
    # cs, assign, lens, max_i, max_j, max_score, pos_score, raw, i_steps,
    # j_steps, B, W, threshold, the four scores, compute_score.
    "dtt_slot_post": [*[_P] * 10, *[_I] * 8, _P],
}
# Host-only entries (no stream, nothing launched): argtypes, restype.
_HOST_ENTRIES = {"dtt_dsoft_scratch_bytes": ([_I, _I, _I, _I], _L),
                 "dtt_shard_count_scratch_bytes": ([_L], _L)}
# The checked library's one more entry: the extents of the next launch.
_SET_EXTENTS = ("dtt_set_extents", [_I, _P, _P])

_locks = {False: threading.Lock(), True: threading.Lock()}
_libs: dict = {}  # checked -> loaded ctypes.CDLL
_entries: dict = {}  # (checked, entry name) -> bound ctypes function


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "darwin_tpu_torch need the CUDA toolkit")
    return path


def build(checked: bool = False) -> str:
    """Compile csrc/*.cu into LIB (LIB_CHECKED with -DDTT_CHECKED when
    checked) unless it is newer than every source and header.

    Returns nvcc's report (ptxas resource usage), or "" when the
    library was up to date.  Writes to a temporary name first, so a
    concurrent process never loads a half-written library.  The two
    libraries may build at once, from two threads."""
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(s.stat().st_mtime for s in CSRC.glob("*.cu*"))
    out = LIB_CHECKED if checked else LIB
    flags = [*NVCC_FLAGS, "-DDTT_CHECKED"] if checked else NVCC_FLAGS
    with _locks[checked]:
        if out.exists() and out.stat().st_mtime >= newest:
            return ""
        out.parent.mkdir(exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        objs = [out.with_name(f".{out.stem}.{s.stem}.{tag}.o")
                for s in sources]
        try:
            procs = [subprocess.Popen(
                [_nvcc(), *flags, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for s, o in zip(sources, objs)]
            try:
                report = [p.communicate(timeout=900)[1] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for s, p, err in zip(sources, procs, report):
                if p.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {s.name}:\n{err[-4000:]}")
            tmp = out.with_name(f".{out.name}.{tag}")
            proc = subprocess.run(
                [_nvcc(), "-shared", *map(str, objs), "-o", str(tmp)],
                capture_output=True, text=True, timeout=300)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        return "".join(report)


def lib(checked: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (the checked one when checked), built
    first if needed."""
    so = _libs.get(checked)
    if so is None:
        build(checked)
        with _locks[checked]:
            so = _libs.get(checked)
            if so is None:
                so = ctypes.CDLL(str(LIB_CHECKED if checked else LIB))
                sigs = dict(_SIGNATURES)
                if checked:
                    sigs[_SET_EXTENTS[0]] = _SET_EXTENTS[1]
                for name, argtypes in sigs.items():
                    fn = getattr(so, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                for name, (argtypes, restype) in _HOST_ENTRIES.items():
                    fn = getattr(so, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                _libs[checked] = so
    return so


def arg(t: torch.Tensor, name: str, dtype: torch.dtype,
        shape: tuple, device: torch.device) -> torch.Tensor:
    """Check one kernel argument and return it."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t


def require_cuda(t: torch.Tensor, what: str) -> torch.device:
    """The CUDA device of t; raises for any device but CPU and CUDA
    (CPU callers take the plain version before getting here)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {t.device}; the kernel "
                         f"runs on CUDA and the plain version on CPU")
    return t.device


def _set_extents(tensors: list) -> None:
    """Hand the checked library the storage extents of a launch's
    tensors."""
    spans = [(s.data_ptr(), s.data_ptr() + s.nbytes())
             for s in (t.untyped_storage() for t in tensors)]
    n = len(spans)
    lo = (ctypes.c_ulonglong * n)(*(a for a, _ in spans))
    hi = (ctypes.c_ulonglong * n)(*(b for _, b in spans))
    rc = lib(True).dtt_set_extents(n, lo, hi)
    if rc != 0:
        raise RuntimeError(f"dtt_set_extents: error {rc} ({n} extents)")


def host_call(entry: str, *args):
    """Call one host-only C entry of the library launch takes and
    return its result."""
    return getattr(lib(CHECKED), entry)(*args)


def launch(entry: str, device: torch.device, *args) -> None:
    """Call one C entry on device's current stream, tensors passed as
    their data pointers; raise on a CUDA error code.  The entry is
    resolved once, and the current device is switched only when it is
    not already device."""
    checked = CHECKED
    fn = _entries.get((checked, entry))
    if fn is None:
        fn = _entries[checked, entry] = getattr(lib(checked), entry)
    if checked:
        _set_extents([a for a in args if isinstance(a, torch.Tensor)])
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == current:
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} at launch")
