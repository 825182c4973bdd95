"""The device engine's records (the record table's download and its
OverlapRecords, both tiers) in ms a read Mbp: engine_records_s summed
over the window's jobs."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    return ms_per_mbp(trace, "engine_records_s")
