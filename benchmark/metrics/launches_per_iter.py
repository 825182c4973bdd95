"""Kernel launches the profiler saw in the window over the engine
iterations the window's jobs ran.  Only a run on the card reads it."""


def read(trace):
    iters = trace["sums"].get("engine_iters", 0)
    if not trace["on_card"] or iters <= 0:
        return None
    return trace["device"]["launches"] / iters
