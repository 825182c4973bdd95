"""Multi-process data parallelism over read ranges, on torch.distributed.

The port of darwin_tpu/parallel/distributed.py.  The reference scales
across CPU threads in one process, each thread owning a contiguous read
range and its own output file (darwin.cpp:619-632, darwin.<cpu_id>.out at
darwin.cpp:174, merged offline with `cat darwin.*.out | sort | uniq`,
README:25).  Here every process of a torch.distributed job

1. parses the same reference and reads and builds or loads the same
   seed table (the CLI's --seed-table: rank 0 builds it, the others load
   it after a barrier),
2. runs D-SOFT and GACT on its contiguous read range (read_range) on its
   own device,
3. contributes its records to a sorted-unique union across processes
   (allgather_records), the on-line form of the reference's merge,
   and ends the group (shutdown).

Only host bytes cross processes (the record blobs and the barrier), so
the process group is gloo on every device: no NCCL, which would also
refuse two ranks on one card.  maybe_initialize reads torchrun's
MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK; DARWIN_TPU_HEARTBEAT_S
(default 100) is the process group's timeout, so a dead peer fails the
survivors' next collective instead of hanging it.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def maybe_initialize(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> bool:
    """Start the gloo process group when one is configured: by the
    arguments, or by torchrun's environment (init_method "env://").
    Returns True when a group of more than one process is (already) up;
    with nothing configured it is a no-op and returns False."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and world_size is None and not any(
            v in os.environ for v in _ENV):
        return False
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    timeout = datetime.timedelta(
        seconds=int(os.environ.get("DARWIN_TPU_HEARTBEAT_S", "100")))
    dist.init_process_group("gloo", init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    return world_size > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def read_range(num_reads: int, index: int | None = None,
               count: int | None = None) -> range:
    """This process's contiguous read range.

    Mirrors the reference's per-thread split `reads_per_thread =
    ceil(num_reads / num_threads)` with the last range truncated
    (darwin.cpp:619-632).
    """
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    per = -(-num_reads // count) if num_reads else 0
    lo = min(index * per, num_reads)
    hi = min(lo + per, num_reads)
    return range(lo, hi)


def allgather_records(records: list[str]) -> list[str]:
    """Deterministic sorted-unique union of records across processes.

    Single-process: plain `sorted(set(...))`.  Multi-process: each
    process newline-joins its records into one byte blob; the blob sizes
    are gathered first, the blobs padded to the largest and gathered,
    split, and reduced with the same `sorted(set(...))`: the same list on
    every process, and the reference's offline `sort | uniq` merge.
    """
    if process_count() == 1:
        return sorted(set(records))
    n = process_count()
    blob = "\n".join(records).encode()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([len(blob)], dtype=torch.int64))
    sizes = [int(s) for s in sizes]
    b_max = max(1, max(sizes))
    buf = torch.zeros(b_max, dtype=torch.uint8)
    buf[:len(blob)] = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
    bufs = [torch.zeros(b_max, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(bufs, buf)
    out: set[str] = set()
    for size, row in zip(sizes, bufs):
        if size:
            out.update(row[:size].numpy().tobytes().decode().split("\n"))
    return sorted(out)


def barrier(name: str = "darwin_tpu") -> None:
    """Cross-process sync point (no-op single-process); name is kept for
    darwin_tpu's signature."""
    del name
    if process_count() > 1:
        dist.barrier()


def shutdown() -> None:
    """End the process group, if one was started, after a barrier (no
    rank leaves while another still gathers): a gloo group left to the
    interpreter's exit can abort the process as it ends."""
    if dist.is_initialized():
        if dist.get_world_size() > 1:
            dist.barrier()
        dist.destroy_process_group()
