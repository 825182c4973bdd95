"""Records formatting (pipeline.format_records: the darwin.<i>.out
lines) in ms a read Mbp: format_s summed over the window's jobs."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    return ms_per_mbp(trace, "format_s")
