"""Tiny scales of the cells for CPU runs of the harness, and a test-only
map cell (cells/: its configuration and traffic, read through here=)."""

import json
from pathlib import Path

SCALES = {
    "ecoli10x_self": {"genome_length": 12000,
                      "lengths": {"mean": 1500, "sd": 600, "min": 800,
                                  "max": 3000, "coverage": 2}},
}
SEED = 2**31 + 4321
HERE = Path(__file__).resolve().parent / "cells"
MAP = "tinymap.batches"
# The per-layer metrics whose readers find something in a map job.
MAP_METRICS = ["align_ms_per_mbp", "slot_occupancy_pct", "dp_roofline_pct",
               "device_idle_pct", "launches_per_iter", "format_ms_per_mbp",
               "read_banks_ms_per_mbp", "engine_prepare_ms_per_mbp",
               "engine_enqueue_ms_per_mbp", "engine_wait_ms_per_mbp",
               "engine_records_ms_per_mbp", "dsoft_device_ms_per_mbp"]


def with_map(spec: dict) -> dict:
    """spec with the map cell, its configuration, and the map cell in
    the workloads of MAP_METRICS (dsoft_device_ms_per_mbp added)."""
    spec = json.loads(json.dumps(spec))
    spec["configs"].append({
        "name": "tinymap", "source": "test only", "reduced": [],
        "file": "benchmark/tests/cells/configs/tinymap.json",
        "why": "the map job at a CPU rehearsal's size"})
    spec["workloads"].append({
        "name": MAP, "config": "tinymap", "traffic": "batches", "chips": 1,
        "why": "batches of reads against a resident three-piece reference"})
    if "dsoft_device_ms_per_mbp" not in {m["name"] for m in
                                          spec["per_layer"]}:
        spec["per_layer"].append({
            "name": "dsoft_device_ms_per_mbp", "unit": "ms/Mbp",
            "better": "lower", "source": "program_span",
            "layer": "device D-SOFT", "moves": "read_mbp_per_s",
            "workloads": []})
    for m in spec["per_layer"]:
        if m["name"] in MAP_METRICS:
            m["workloads"].append(MAP)
    return spec


def where(cell: str, spec: dict) -> dict:
    """run_cell's (and control_mismatches') spec, here and scale for a
    cell: the map cell from cells/ at its own size, the others from the
    benchmark's folder at SCALES."""
    if cell == MAP:
        return dict(spec=with_map(spec), here=HERE, scale=None)
    cfg = next(w["config"] for w in spec["workloads"] if w["name"] == cell)
    return dict(spec=spec, scale=SCALES[cfg])
