"""The device engine (engine/device_batch.py) in ms a read Mbp: align_s
summed over the window's jobs."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    return ms_per_mbp(trace, "align_s")
