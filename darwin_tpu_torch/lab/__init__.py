"""The kernel lab: ports of the JAX package's kernel tools (tools/).

Each module runs as ``python -m darwin_tpu_torch.lab.<name>`` and
mirrors one tool: ``geom_sweep`` (tools/geom_sweep.py), ``kernel_lab``
(tools/kernel_lab.py and tools/ilp_probe.py), ``plane2_probe`` and
``scanshift_probe``.  Each takes ``--device`` (default ``cuda``, which
must be present; ``--device cpu`` runs the kernels' plain versions at a
size small enough for a CPU), times with CUDA events on the card, and
prints the same sink the JAX tool computes from the same inputs, summed
with int32 wraparound, so that a card run and a JAX run can be compared
by eye.  A CPU run's times are host wall times, not device times.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


# The tools' scoring (the reference's default params).
SCORING = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu, "
                        "which runs the kernels' plain versions")


def resolve_device(name: str) -> torch.device:
    """The device named; raises when it is CUDA and there is none."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           f"(give --device cpu to run the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: cuda or cpu")
    return dev


def launch_counters() -> dict:
    """{name: wrapper} of the main paths' kernel wrappers, each of which
    counts its launches on its .launches: the DP, the three walkers, the
    span fetch, the slot loop's two, the device D-SOFT's three kernels
    and the seed table's two."""
    from ..dsoft import sharded_table as st
    from ..dsoft.device import dsoft_device_batch
    from ..index import table_device as td
    from ..ops import slot_loop as sl
    from ..ops import traceback as tb
    from ..ops.dp import align_tiles
    from ..ops.tile_fetch import fetch_tiles

    return {"align_tiles": align_tiles, "traceback": tb.traceback,
            "traceback_packed": tb.traceback_packed,
            "traceback_packed6": tb.traceback_packed6,
            "fetch_tiles": fetch_tiles, "slot_prepare": sl.slot_prepare,
            "slot_post": sl.slot_post, "dsoft_device": dsoft_device_batch,
            "dsoft_shard_scan": st.shard_scan,
            "dsoft_shard_count": st.shard_count,
            "seed_minimizers": td.minimizer_keys,
            "seed_sort": td.sort_keys}


def related_batches(V: int, B: int, T: int):
    """V batches of B [T]-byte ref/query tiles as tools/kernel_lab.py
    and tools/plane2_probe.py make them from seed 0: ACGT refs, queries
    with 10% of bases redrawn.  Returns (refs, queries) [V, B, T]
    uint8."""
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = alpha[rng.integers(0, 4, size=(V, B, T))]
    queries = refs.copy()
    mut = rng.random((V, B, T)) < 0.1
    queries[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
    return refs, queries


def wrap32(x: int) -> int:
    """x as an int32 with wraparound, as jnp sums int32."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def sum32(t: torch.Tensor) -> int:
    """Sum of an integer tensor with int32 wraparound."""
    return wrap32(int(t.sum(dtype=torch.int64)))


def time_ms(fn, device: torch.device, reps: int = 3):
    """Mean time of fn() over reps calls after one warm-up call, and the
    last result.  CUDA events on a card; the host clock on a CPU."""
    out = fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def clock(device: torch.device) -> str:
    """What time_ms measured on this device."""
    return "CUDA events" if device.type == "cuda" else "CPU wall"
