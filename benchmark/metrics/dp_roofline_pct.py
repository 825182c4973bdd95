"""The DP kernels' (ops/dp.py -> csrc/dp.cu, csrc/dp16.cu) share of
their roofline: the least time of every DP call of the window over the
profiler's device time of the kernels named align_tiles*, in %.  A
call's least time is the longer of its bytes at 3.35 TB/s (the tiles'
bases, the direction bytes of the cells their lengths need, lengths and
scores) and 15 int32 operations a needed cell at the derived INT32 peak
(benchmark/roofline.py).  Only a run on the card reads it."""

from benchmark.roofline import dp_bound, dp_bytes, dp_cells


def read(trace):
    if not trace["on_card"]:
        return None
    k_s = sum(s for n, s in trace["device"]["kernels"].items()
              if "align_tiles" in n)
    if k_s <= 0 or not trace["dp_calls"]:
        return None
    least = 0.0
    for c in trace["dp_calls"]:
        rl, ql = c["ref_len"].cpu().numpy(), c["query_len"].cpu().numpy()
        least += dp_bound(
            dp_bytes(rl, ql, c["T"], c["cell_bytes"], c["fixed_bytes"]),
            dp_cells(rl, ql, c["T"]))[0]
    return 100.0 * least / k_s
