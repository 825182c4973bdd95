"""Instructions a DP cell of the split kernels, read from their SASS.

Disassembles the port's kernel library (``cuobjdump -sass``) and, for
each split-path instantiation of csrc/dp.cu and csrc/dp16.cu named on
the command line (default: the int32 split kernel and the 16-bit one at
C = 16 in bytes and packed6, and the 16-bit one in plane 2), finds the
row body: the longest straight-line block (no branch, barrier, warp
sync or exit between its ends) that holds the cell recurrence's DPX
instructions.  It prints the block's
instructions, the cells it computes (C a lane-row for the int32 kernel,
2C for the 16-bit one: a cell of each tile), their quotient, the
opcodes most used, and the kernel's registers and spills from the
build's ``-Xptxas -v`` report where one is given.  The direction rows'
emission lies outside the row body and is not counted.

Usage (needs nvcc and cuobjdump, so the card's host):
  python3 tools/torch_sass_cells.py [--kernel split:16:bytes ...]
      [--out FILE]
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FORMATS = {"bytes": 0, "packed": 1, "packed6": 2, "plane2": 3}
DEFAULT = ("split:16:bytes", "split:16:packed6", "split16:16:bytes",
           "split16:16:packed6", "split16:16:plane2")
# Opcodes that end a straight-line block.
CONTROL = re.compile(r"^(BRA|BRX|JMP|JMX|CALL|RET|EXIT|BSSY|BSYNC|WARPSYNC"
                     r"|BAR|BPT|NANOSLEEP|YIELD)\b")
# The cell recurrence's DPX instructions (M's add-max, H's three-way max).
DPX = re.compile(r"^(VIADDMNMX|VIMNMX3)\b")
INSN = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                  r"([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.x]+)?")


def mangled(kind: str, C: int, fmt: str) -> str:
    """The fragment of the kernel's mangled name for one instantiation:
    align_tiles_split<C, 1, FMT> or align_tiles_split16<C, FMT>."""
    f = FORMATS[fmt]
    if kind == "split":
        return f"17align_tiles_splitILi{C}ELi1ELi{f}EE"
    return f"19align_tiles_split16ILi{C}ELi{f}EE"


def functions(sass: str) -> dict:
    """{mangled name: [opcode with modifiers, ...]} of a cuobjdump -sass
    listing."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = part.partition("\n")
        ops = []
        for line in body.splitlines():
            m = INSN.match(line)
            if m:
                ops.append(m.group(1) + (m.group(2) or ""))
        out[name.strip()] = ops
    return out


def row_body(ops: list) -> list:
    """The straight-line block with the most DPX instructions."""
    best, block = [], []
    for op in ops + ["EXIT"]:
        if CONTROL.match(op):
            if sum(bool(DPX.match(o)) for o in block) > sum(
                    bool(DPX.match(o)) for o in best):
                best = block
            block = []
        else:
            block.append(op)
    return best


def registers(report: str, frag: str) -> dict:
    """Registers and spill bytes of the kernel named frag in a ptxas -v
    report (empty where it is not there)."""
    lines = report.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and frag in line:
            text = " ".join(lines[n + 1:n + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            return {"registers": int(regs.group(1)) if regs else None,
                    "spill_stores": int(spill.group(1)) if spill else None}
    return {}


def count(sass: str, specs, report: str = "") -> list:
    """One dict a spec "kind:C:fmt" (kind split or split16)."""
    funcs = functions(sass)
    rows = []
    for spec in specs:
        kind, c, fmt = spec.split(":")
        frag = mangled(kind, int(c), fmt)
        name = next((n for n in funcs if frag in n), None)
        if name is None:
            raise SystemExit(f"{spec}: no kernel {frag} in the library")
        body = row_body(funcs[name])
        cells = int(c) * (2 if kind == "split16" else 1)
        hist = collections.Counter(op.split(".")[0] for op in body)
        rows.append(dict(kernel=spec, instructions=len(body), cells=cells,
                         per_cell=len(body) / cells,
                         function=len(funcs[name]),
                         top=hist.most_common(12),
                         **registers(report, frag)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", action="append",
                    help="kind:C:format, kind split (int32) or split16 "
                         f"(default {' '.join(DEFAULT)})")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    from darwin_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("cuobjdump is not on this host", file=sys.stderr)
        return 2
    report = _build.build()
    sass = subprocess.run([tool, "-sass", str(_build.LIB)], check=True,
                          capture_output=True, text=True).stdout
    rows = count(sass, args.kernel or DEFAULT, report)
    for r in rows:
        print(f"{r['kernel']}: row body {r['instructions']} instructions "
              f"for {r['cells']} cells = {r['per_cell']:.2f} a cell "
              f"(function {r['function']}; registers "
              f"{r.get('registers')}, spill stores {r.get('spill_stores')}"
              f"); top {r['top']}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
