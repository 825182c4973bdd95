"""The device engine's build (pipeline.make_merged_engine: the merged
read bank, its upload and, against a genome new to the device, the
genome's bank) in ms a read Mbp: engine_build_s summed over the
window's jobs.  run_pipeline writes it in a self job; run_device_merged
writes it where it builds the engine for a batch (a map job)."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    return ms_per_mbp(trace, "engine_build_s")
