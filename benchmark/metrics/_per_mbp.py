"""A program timer's milliseconds a read Mbp of the window's jobs."""


def ms_per_mbp(trace: dict, key: str):
    s = trace["sums"].get(key)
    if s is None or trace["mbp"] <= 0:
        return None
    return 1e3 * s / trace["mbp"]
