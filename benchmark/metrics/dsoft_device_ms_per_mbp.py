"""Device D-SOFT (dsoft/device.py -> csrc/dsoft.cu, through
pipeline.collect_calls_device) in ms a read Mbp: seed_s summed over the
window's jobs, where the configuration seeds on the device (the index's
build and upload, the kernel, the hits' download and decoding, the
overflowed reads' host fallback)."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    if trace["cell"]["config"]["dsoft"] != "device":
        return None
    return ms_per_mbp(trace, "seed_s")
