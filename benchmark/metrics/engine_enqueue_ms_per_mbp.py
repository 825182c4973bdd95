"""The device engine's launches (its slot loops' host time outside the
stop check's wait: the per-call tables' upload, each iteration's
launches, the drain's state export) in ms a read Mbp: engine_enqueue_s
summed over the window's jobs."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    return ms_per_mbp(trace, "engine_enqueue_s")
