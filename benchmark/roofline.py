"""The yardstick's arithmetic: peaks, a DP call's least time, and a
profiled window's device time.

Frozen copies of the repository's chip_smoke.bound / dp_bound counting
and of the profiling tool's device_summary, with one change to the
latter: the device's busy time is the union of the device intervals, so
that operations overlapping on two streams count once.

Peaks of one NVIDIA H100 SXM:
* HBM_BYTES_S, 3.35 TB/s, is the data sheet's bandwidth.
* INT32_OPS_S is derived, not published: 132 SMs x 64 INT32 lanes x
  1.98 GHz boost clock, one operation a lane a cycle.  A share against
  it says which bound binds (`bound_by`).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
# int32 operations a DP cell needs, as the kernels' sources count them:
# M an add and a max; I and D two adds, a max and a >= each; H a max of
# three with its tie order, two compares; the direction byte three.
DP_OPS_CELL = 15
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations") of work that moves
    nbytes and does ops int32 operations."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / INT32_OPS_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def dp_cells(ref_len, query_len, T: int) -> int:
    """The cells a DP call's tiles need: min(rlen, T) x min(qlen, T) a
    tile (sequences or arrays of lengths)."""
    r = np.clip(np.asarray(ref_len, dtype=np.int64), 0, T)
    q = np.clip(np.asarray(query_len, dtype=np.int64), 0, T)
    return int((r * q).sum())


def dp_bytes(ref_len, query_len, T: int, cell_bytes: float,
             fixed_bytes: int) -> int:
    """The bytes a DP call has to move: each tile's reference and query
    bases once, the direction bytes of the cells its lengths need
    (cell_bytes a cell), and the lengths and per-tile scores
    (fixed_bytes) whatever the lengths."""
    r = np.clip(np.asarray(ref_len, dtype=np.int64), 0, T)
    q = np.clip(np.asarray(query_len, dtype=np.int64), 0, T)
    return int(r.sum() + q.sum() + cell_bytes * (r * q).sum() + fixed_bytes)


def dp_bound(nbytes: int, cells: int) -> tuple[float, str]:
    """A DP call's bound: the bytes it has to move, and DP_OPS_CELL
    operations a cell its lengths need."""
    return bound(nbytes, DP_OPS_CELL * cells)


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def idle_gaps(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The (start_ns, end_ns) stretches of [lo, hi] that no interval
    covers, longest first."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


def device_summary(device_events, launches: int, lo: int, hi: int) -> dict:
    """A window [lo, hi] (ns) of device events [(name, start_ns,
    end_ns)]: busy_s (their union inside the window), window_s,
    launches, and kernels {name: seconds summed}."""
    clipped = [(max(s, lo), min(e, hi)) for _, s, e in device_events
               if e > lo and s < hi]
    kernels: dict[str, float] = {}
    for name, s, e in device_events:
        kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e9
    return dict(busy_s=union_seconds(clipped), window_s=(hi - lo) / 1e9,
                launches=launches, kernels=kernels)
