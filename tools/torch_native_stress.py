"""Build and run the native host library's stress program on the port's
build.

darwin_tpu_torch/native_src/stress_main.cpp (a copy of darwin_tpu/
native/src/stress_main.cpp) drives the two threaded parts of the native
library, the seed-table build and the D-SOFT batch, at several thread
counts and exits 0 when every count gives the same result.  This tool
compiles it with the port's copy of dtnative.cpp under the flags the
port builds the library with (darwin_tpu_torch/native.py: -pthread in
place of the reference's -fopenmp), less -shared and -fPIC, and runs
it; with --tsan, under ThreadSanitizer (-fsanitize=thread -g,
TSAN_OPTIONS=halt_on_error=1), which fails the run on a data race, as
darwin_tpu/native/Makefile's stress and tsan targets do.

Usage:
    python tools/torch_native_stress.py [--tsan] [--out DIR]

The binary goes to DIR (default darwin_tpu_torch/_build/).  Exits with
the stress program's code, or 1 when it does not build.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from darwin_tpu_torch import native  # noqa: E402

STRESS_SRC = native.SRC.parent / "stress_main.cpp"
TSAN_FLAGS = ["-fsanitize=thread", "-g"]


def flags(tsan: bool = False) -> list[str]:
    """The port's library flags for an executable, with ThreadSanitizer's
    where asked."""
    out = [f for f in native.CXX_FLAGS if f not in ("-shared", "-fPIC")]
    return out + (TSAN_FLAGS if tsan else [])


def build(out_dir: Path, tsan: bool = False) -> tuple[Path, str | None]:
    """Compile the stress program into out_dir; (its path, None) or
    (path, the compiler's error)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = out_dir / ("dtstress_tsan" if tsan else "dtstress")
    cmd = [native._cxx(), *flags(tsan), str(native.SRC), str(STRESS_SRC),
           "-o", str(exe)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return exe, f"{cmd[0]}: {e}"
    return exe, (None if r.returncode == 0
                 else r.stderr or f"{cmd[0]} exited {r.returncode}")


def run(exe: Path, timeout: int = 600) -> subprocess.CompletedProcess:
    """Run a built stress program (TSAN_OPTIONS=halt_on_error=1 set)."""
    env = {**os.environ, "TSAN_OPTIONS": "halt_on_error=1"}
    return subprocess.run([str(exe)], capture_output=True, text=True,
                          timeout=timeout, env=env)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tsan", action="store_true",
                   help="build and run under ThreadSanitizer")
    p.add_argument("--out", type=Path, default=native.BUILD_DIR)
    args = p.parse_args(argv)
    exe, err = build(args.out, args.tsan)
    if err is not None:
        print(f"build failed:\n{err}", file=sys.stderr)
        return 1
    print(f"built {exe} ({' '.join(flags(args.tsan))})", flush=True)
    r = run(exe)
    sys.stdout.write(r.stdout)
    sys.stderr.write(r.stderr[-4000:])
    print(f"exit {r.returncode}", flush=True)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
