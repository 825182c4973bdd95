"""The device engine's slot occupancy: active slot-iterations over the
iterations times the slots of each engine loop that ran (both tiers of
the drain), in %."""


def read(trace):
    cap = sum(b * it for b, it, _ in trace["loops"])
    if cap == 0:
        return None
    return 100.0 * sum(a for _, _, a in trace["loops"]) / cap
