"""The benchmark of darwin_tpu_torch: one H100, read Mbp/s end to end.

Run a cell with ``python3 benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; BENCHMARK.json
at the root names the cells, their configurations and metrics.
"""
