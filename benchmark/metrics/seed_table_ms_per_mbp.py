"""Seed-table build (index/seed_table.py) in ms a read Mbp: the
pipeline's table_s summed over the window's jobs; absent where the jobs
build no table (a resident table is set-up)."""

from benchmark.metrics._per_mbp import ms_per_mbp


def read(trace):
    return ms_per_mbp(trace, "table_s")
