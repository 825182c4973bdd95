"""The device engine's stop-check wait (its slot loops' host time
blocked in the per-iteration read of the loop's counters) in ms a read
Mbp: engine_wait_s summed over the window's jobs."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    return ms_per_mbp(trace, "engine_wait_s")
