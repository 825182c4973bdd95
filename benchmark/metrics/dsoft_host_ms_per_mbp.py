"""Host D-SOFT (dsoft/filter.py through native.py) in ms a read Mbp:
seed_s summed over the window's jobs, where the configuration seeds on
the host."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    if trace["cell"]["config"]["dsoft"] != "host":
        return None
    return ms_per_mbp(trace, "seed_s")
