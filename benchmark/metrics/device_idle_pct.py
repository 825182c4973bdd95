"""The device's idle share of the traced window: 100 minus the union of
its operations' intervals (torch.profiler) over the window, in %.  Only
a run on the card reads it."""


def read(trace):
    d = trace["device"]
    if not trace["on_card"] or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
