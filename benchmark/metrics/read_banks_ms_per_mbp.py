"""The read banks (pipeline.read_banks: the reads' forward and
reverse-complement banks) in ms a read Mbp: read_banks_s summed over
the window's jobs."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    return ms_per_mbp(trace, "read_banks_s")
