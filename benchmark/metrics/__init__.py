"""Per-layer metric readers, one module a metric, found by its name in
BENCHMARK.json.  Each has read(trace) -> float | None: trace is the
traced run's dict (cell, mbp, sums of the program's metrics over the
window's jobs, loops, dp_calls, device, on_card); None where the run has
nothing to read for the metric."""
