"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by nvcc for sm_90a, one nvcc process per
source, all started together (the native host library's C++ source lives
in ``native_src/``, which native.py builds with g++), and the objects
are linked into one shared library, ``_build/libdtt_kernels.so``, with a
plain C interface that is bound with ctypes.  The build happens at first
use (never at import) and again whenever a source or header in csrc/ is
newer than the library.  Each C entry launches on the stream it is given
and returns ``cudaGetLastError()``; ``launch`` raises if that is not 0.
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
# -Xptxas -v reports registers / shared memory / spills per kernel;
# build() returns that report.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures (see the csrc files); the last argument is the stream.
_SIGNATURES = {
    "dtt_align_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P, _P, _P, _P, _P, _P, _P],
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
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_entries: dict = {}  # entry name -> bound ctypes function


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "darwin_tpu_torch need the CUDA toolkit")
    return path


def build() -> str:
    """Compile csrc/*.cu into LIB unless it is newer than every source
    and header.

    Returns nvcc's report (ptxas resource usage), or "" when the
    library was up to date.  Writes to a temporary name first, so a
    concurrent process never loads a half-written library."""
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(s.stat().st_mtime for s in CSRC.glob("*.cu*"))
    with _lock:
        if LIB.exists() and LIB.stat().st_mtime >= newest:
            return ""
        LIB.parent.mkdir(exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        objs = [LIB.with_name(f".{s.stem}.{tag}.o") for s in sources]
        try:
            procs = [subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
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
            tmp = LIB.with_name(f".{LIB.name}.{tag}")
            proc = subprocess.run(
                [_nvcc(), "-shared", *map(str, objs), "-o", str(tmp)],
                capture_output=True, text=True, timeout=300)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, LIB)
        return "".join(report)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        with _lock:
            if _lib is None:
                so = ctypes.CDLL(str(LIB))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(so, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = so
    return _lib


def arg(t: torch.Tensor, name: str, dtype: torch.dtype,
        shape: tuple, device: torch.device) -> int:
    """Check one kernel argument and return its data pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def require_cuda(t: torch.Tensor, what: str) -> torch.device:
    """The CUDA device of t; raises for any device but CPU and CUDA
    (CPU callers take the plain version before getting here)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {t.device}; the kernel "
                         f"runs on CUDA and the plain version on CPU")
    return t.device


def launch(entry: str, device: torch.device, *args) -> None:
    """Call one C entry on device's current stream; raise on a CUDA
    error code.  The entry is resolved once, and the current device is
    switched only when it is not already device."""
    fn = _entries.get(entry)
    if fn is None:
        fn = _entries[entry] = getattr(lib(), entry)
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
