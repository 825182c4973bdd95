"""The device engine's host preparation (DeviceGactEngine.run_async
before its loop: the call arrays, the drain gate's simulation, the
start state; the second tier's state download) in ms a read Mbp:
engine_prepare_s summed over the window's jobs."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    return ms_per_mbp(trace, "engine_prepare_s")
