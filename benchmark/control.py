"""The check's control: the plain reference with 8-bit saturating cell
scores, put in the program's place, has to come out as not correct.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does, takes the first
input's sample, and compares the control's records of the sample with
the reference's, as a run compares the program's: for a self job the
reads against themselves (same_file), for a map job against the cell's
reference pieces.  It prints one line a seed and, last, one JSON object
with the mismatches of every seed.  Not part of a benchmark run: it
reads the control's side of the limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402
from benchmark.reference.overlap import reference_records  # noqa: E402


def control_mismatches(name: str, seed: int, device: str,
                       scale: dict | None = None, *, spec: dict | None = None,
                       here: Path = harness.HERE) -> dict:
    """harness.check's numbers with the control's records in place of
    the program's, on the first input of the cell's pool."""
    c = harness.load_cell(name, spec or harness.load_spec(), here)
    cfg, traffic = c["config"], c["traffic"]
    pieces, pool = harness.make_data(cfg, traffic, seed, scale)
    inputs = pool[0]
    ids = harness.sample_reads(inputs, traffic["check"], seed, 0)
    reads = inputs.pairs()
    same = harness.job_kind(cfg) == "self"
    control = reference_records(reads if same else pieces, reads,
                                cfg["params"], same_file=same, read_ids=ids,
                                device=device, saturate=True)
    return harness.check(cfg, traffic, pieces, pool, [(0, control)], seed,
                         device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {}
    for seed in args.seeds:
        t = time.perf_counter()
        r = control_mismatches(args.workload, seed, args.device)
        out[seed] = r
        print(f"seed {seed}: control record_mismatches "
              f"{r['record_mismatches']} of {r['reference_records']} "
              f"reference records ({time.perf_counter() - t:.1f} s)",
              flush=True)
    print(json.dumps({"workload": args.workload, "control": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
