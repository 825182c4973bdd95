"""The native host library (seed-table keys, D-SOFT, FASTA), built by
the port from its copy of the reference's source.

``native_src/dtnative.cpp`` (a copy of darwin_tpu/native/src/
dtnative.cpp, kept out of csrc/ so that the nvcc build never takes it)
is compiled into ``_build/libdtnative-<key>.so`` at first use.  The
reference's own build (``darwin_tpu/native/__init__.py``) passes
``-fopenmp``, which a g++ without libgomp cannot link; the source
threads with ``std::thread`` and has no OpenMP pragma, so the port
builds it with ``-pthread`` instead and otherwise the same flags.

The library is compiled with ``-march=native``, so it must not travel
between hosts.  Its file name carries a key over the compiler and
flags, the source's sha256 and the host CPU's model line from
``/proc/cpuinfo``; a library with another key is never loaded, and a
new one is built.

When the build fails, ``available()`` is False, the compiler's error is
printed once to stderr, and callers take their NumPy fallbacks, as the
reference does.  The ctypes signatures (``_declare``) are the
reference's.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "native_src" / "dtnative.cpp"
BUILD_DIR = _DIR / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-funroll-loops", "-march=native", "-Wall"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def cpu_line() -> str:
    """The host CPU's model line (/proc/cpuinfo), or what platform
    reports where that file has none."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}"


def library_path(cpu: str | None = None,
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for this compiler, these flags, this source
    and this CPU (default: the host's) lives."""
    h = hashlib.sha256()
    for part in (" ".join([_cxx(), *CXX_FLAGS]).encode(), SRC.read_bytes(),
                 (cpu_line() if cpu is None else cpu).encode()):
        h.update(part)
        h.update(b"\0")
    return build_dir / f"libdtnative-{h.hexdigest()[:16]}.so"


def build(path: Path) -> str | None:
    """Compile SRC into path unless it exists.  Returns None on
    success, else the compiler's error.  A file lock serialises
    concurrent processes, and the library is written under a temporary
    name first, so no process loads a half-written file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / ".libdtnative.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return None
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run([_cxx(), *CXX_FLAGS, str(SRC), "-o",
                                   str(tmp)], capture_output=True,
                                  text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"{_cxx()}: {e}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return proc.stderr or f"{_cxx()} exited {proc.returncode}"
        os.replace(tmp, path)
    return None


def _declare(lib: ctypes.CDLL) -> None:
    """The C signatures of native_src/dtnative.cpp's entry points."""
    c = ctypes
    u8p, i64p, u32p, u64p = (c.POINTER(c.c_uint8), c.POINTER(c.c_int64),
                             c.POINTER(c.c_uint32), c.POINTER(c.c_uint64))
    lib.dt_version.restype = c.c_int
    lib.dt_buf_size.argtypes = [c.c_void_p]
    lib.dt_buf_size.restype = c.c_int64
    lib.dt_buf_fill.argtypes = [c.c_void_p, u64p]
    lib.dt_buf_free.argtypes = [c.c_void_p]
    lib.dt_scan_minimizers.argtypes = [u8p, c.c_int64, c.c_int, c.c_int,
                                       c.c_int]
    lib.dt_scan_minimizers.restype = c.c_void_p
    lib.dt_build_table.argtypes = [u8p, c.c_int64, c.c_int, c.c_int,
                                   c.c_int]
    lib.dt_build_table.restype = c.c_void_p
    lib.dt_dsoft_batch.argtypes = [
        u32p, u32p, c.c_int64, c.c_int, c.c_int64, c.c_int64, c.c_int64,
        c.c_int, u8p, i64p, i64p, i64p, c.c_int64, c.c_int64, c.c_int64,
        c.c_int64, c.c_int]
    lib.dt_dsoft_batch.restype = c.c_void_p
    lib.dt_dsoft_total.argtypes = [c.c_void_p]
    lib.dt_dsoft_total.restype = c.c_int64
    lib.dt_dsoft_fill.argtypes = [c.c_void_p, i64p, i64p, i64p]
    lib.dt_dsoft_free.argtypes = [c.c_void_p]
    lib.dt_fasta_parse.argtypes = [c.c_char_p]
    lib.dt_fasta_parse.restype = c.c_void_p
    lib.dt_fasta_ok.argtypes = [c.c_void_p]
    lib.dt_fasta_ok.restype = c.c_int
    for name in ("dt_fasta_nrecords", "dt_fasta_seq_total",
                 "dt_fasta_desc_total"):
        getattr(lib, name).argtypes = [c.c_void_p]
        getattr(lib, name).restype = c.c_int64
    lib.dt_fasta_fill.argtypes = [c.c_void_p, u8p, i64p, u8p, i64p]
    lib.dt_fasta_free.argtypes = [c.c_void_p]


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        err = build(path)
        if err is None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                err = str(e)
            else:
                _declare(lib)
                if lib.dt_version() == 1:
                    _lib = lib
                else:
                    err = f"{path}: unexpected dt_version"
        if err is not None:
            print(f"darwin_tpu_torch.native: build of {SRC.name} failed; "
                  f"the NumPy fallbacks run instead:\n{err}",
                  file=sys.stderr)
    return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("darwin_tpu_torch.native is unavailable")
    return lib


def build_table_keys(ref: np.ndarray, k: int, w: int,
                     num_threads: int | None = None) -> np.ndarray:
    """Sorted (hash << 32) | pos seed-table keys (parallel scan and
    sort)."""
    lib = _need()
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    h = lib.dt_build_table(_ptr(ref, ctypes.c_uint8), len(ref), k, w,
                           num_threads or os.cpu_count() or 1)
    out = np.empty(lib.dt_buf_size(h), dtype=np.uint64)
    if len(out):
        lib.dt_buf_fill(h, _ptr(out, ctypes.c_uint64))
    lib.dt_buf_free(h)
    return out


def dsoft_batch(hashes: np.ndarray, pos: np.ndarray, k: int, w: int,
                bin_size: int, ref_size: int, kmer_max_occ: int,
                flat: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                read_ids: np.ndarray, num_seeds_cap: int, threshold: int,
                max_candidates: int, num_threads: int | None = None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multithreaded D-SOFT over a batch of reads.

    Returns (counts, hits, offsets): per-read candidate counts (aligned
    with read_ids) and the candidates concatenated in read order, each
    read's candidates in emission order.
    """
    lib = _need()
    hashes = np.ascontiguousarray(hashes, dtype=np.uint32)
    pos = np.ascontiguousarray(pos, dtype=np.uint32)
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    read_ids = np.ascontiguousarray(read_ids, dtype=np.int64)
    n = len(read_ids)
    i64 = ctypes.c_int64
    h = lib.dt_dsoft_batch(
        _ptr(hashes, ctypes.c_uint32), _ptr(pos, ctypes.c_uint32),
        len(hashes), k, bin_size, ref_size, kmer_max_occ, w,
        _ptr(flat, ctypes.c_uint8), _ptr(starts, i64), _ptr(lens, i64),
        _ptr(read_ids, i64), n, num_seeds_cap, threshold, max_candidates,
        num_threads or os.cpu_count() or 1)
    total = lib.dt_dsoft_total(h)
    counts = np.empty(n, dtype=np.int64)
    hits = np.empty(total, dtype=np.int64)
    offsets = np.empty(total, dtype=np.int64)
    lib.dt_dsoft_fill(h, _ptr(counts, i64), _ptr(hits, i64),
                      _ptr(offsets, i64))
    lib.dt_dsoft_free(h)
    return counts, hits, offsets


def parse_fasta(path) -> list | None:
    """Native FASTA load; None when the library is unavailable or the
    file does not parse (the caller then runs the pure parser, which
    raises the detailed error)."""
    lib = _load()
    if lib is None:
        return None
    h = lib.dt_fasta_parse(str(path).encode())
    if not h:
        return None
    try:
        if not lib.dt_fasta_ok(h):
            return None
        n = lib.dt_fasta_nrecords(h)
        seq_blob = np.empty(lib.dt_fasta_seq_total(h), dtype=np.uint8)
        desc_blob = np.empty(lib.dt_fasta_desc_total(h), dtype=np.uint8)
        seq_off = np.empty(n + 1, dtype=np.int64)
        desc_off = np.empty(n + 1, dtype=np.int64)
        lib.dt_fasta_fill(h, _ptr(seq_blob, ctypes.c_uint8),
                          _ptr(seq_off, ctypes.c_int64),
                          _ptr(desc_blob, ctypes.c_uint8),
                          _ptr(desc_off, ctypes.c_int64))
    finally:
        lib.dt_fasta_free(h)

    from darwin_tpu_torch.io.fasta import FastaRecord, split_fields
    seq_bytes = seq_blob.tobytes()
    desc_bytes = desc_blob.tobytes()
    return [FastaRecord(
        split_fields(desc_bytes[desc_off[i]:desc_off[i + 1]].decode("ascii")),
        seq_bytes[seq_off[i]:seq_off[i + 1]].decode("ascii"))
        for i in range(n)]
