"""Memory observability for the port: host RSS polling and the cards'
memory.

The counterpart of tools/mem_usage.py.  ``watch`` polls a process's
VmRSS from /proc as the original does; ``device`` reports each visible
CUDA card's memory: bytes in use (torch.cuda.mem_get_info: total less
free, every process on the card), this process's peak allocated
(torch.cuda.memory_stats) and the card's total.  Without a card it says
so and exits 0.  peak_rss_gb and peak_device_gb are what the port's
scale tools print.

Usage:
    python tools/torch_mem_usage.py watch <pid> [interval_s]
    python tools/torch_mem_usage.py device
"""

from __future__ import annotations

import resource
import sys
import time
from pathlib import Path


def rss_kb(pid: int) -> int | None:
    try:
        for line in Path(f"/proc/{pid}/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    except (FileNotFoundError, ProcessLookupError):
        return None
    return None


def watch(pid: int, interval: float) -> None:
    peak = 0
    while True:
        kb = rss_kb(pid)
        if kb is None:
            break
        peak = max(peak, kb)
        print(f"rss_mb={kb / 1024:.1f} peak_mb={peak / 1024:.1f}",
              flush=True)
        time.sleep(interval)
    print(f"process {pid} exited; peak_rss_mb={peak / 1024:.1f}")


def peak_rss_gb() -> tuple[float, float]:
    """(this process's peak RSS, the largest peak RSS of its reaped
    children), in GB (ru_maxrss is in KiB on Linux)."""
    self_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    kids_kb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    return self_kb * 1024 / 1e9, kids_kb * 1024 / 1e9


def peak_device_gb(device) -> float | None:
    """Peak bytes allocated by this process on a CUDA device since the
    last torch.cuda.reset_peak_memory_stats, in GB; None off CUDA."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def memory_line(device) -> str:
    """Peak host RSS and peak device memory as one line of text."""
    self_gb, kids_gb = peak_rss_gb()
    dev_gb = peak_device_gb(device)
    return (f"peak RSS: self {self_gb:.2f} GB, children {kids_gb:.2f} GB; "
            f"peak device memory: "
            + (f"{dev_gb:.2f} GB" if dev_gb is not None
               else f"none ({device} is no CUDA device)"))


def host_memory_line() -> str:
    """The host's total and available memory (/proc/meminfo), as free -g
    gives them, in GB."""
    info = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, val = line.split(":", 1)
        info[key] = int(val.split()[0]) * 1024
    return (f"host memory: total {info['MemTotal'] / 1e9:.1f} GB, "
            f"available {info['MemAvailable'] / 1e9:.1f} GB")


def device_stats() -> None:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible")
        return
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        peak = torch.cuda.memory_stats(i).get("allocated_bytes.all.peak", 0)
        print(f"cuda:{i} {torch.cuda.get_device_name(i)}: "
              f"{(total - free) / 2**20:.1f} MiB in use, "
              f"{peak / 2**20:.1f} MiB peak allocated, "
              f"{total / 2**20:.1f} MiB total")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("watch", "device"):
        print(__doc__)
        return 2
    if argv[0] == "watch":
        watch(int(argv[1]), float(argv[2]) if len(argv) > 2 else 1.0)
    else:
        device_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
