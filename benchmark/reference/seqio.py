"""Plain inputs of the reference: FASTA, params.cfg, reverse complement.

Written from the Darwin reference's formats (fasta.cpp, ConfigFile.cpp,
darwin.cpp:110-147), with no code of the program under test.
"""

from __future__ import annotations

import configparser

import numpy as np

# params.cfg's sections and keys, with the reference's defaults.
PARAM_KEYS = {
    "GACT_scoring": {"match": 1, "mismatch": -1, "gap_open": -1,
                     "gap_extend": -1},
    "DSOFT_params": {"seed_size": 14, "bin_size": 64, "window_size": 4,
                     "threshold": 21, "num_seeds": 800,
                     "seed_occurence_multiple": 32,
                     "max_candidates": 1_000_000, "num_nz_bins": 2_500_000},
    "GACT_first_tile": {"first_tile_size": 128,
                        "first_tile_score_threshold": 35},
    "GACT_extend": {"tile_size": 320, "tile_overlap": 120},
}
DEFAULT_PARAMS = {k: v for sec in PARAM_KEYS.values() for k, v in sec.items()}

_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTNacgtn", b"TGCANtgcan"):
    _COMP[_a] = _b


def read_params(path) -> dict:
    """A params.cfg as a flat dict, defaults filled in."""
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    with open(path) as f:
        cp.read_file(f)
    out = {}
    for sec, keys in PARAM_KEYS.items():
        for key, default in keys.items():
            out[key] = (int(float(cp.get(sec, key)))
                        if cp.has_option(sec, key) else default)
    return out


def read_fasta(path) -> list[tuple[str, np.ndarray]]:
    """[(name, uint8 bases)]: the name is the header's first word."""
    recs: list[tuple[str, list[bytes]]] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                recs.append((line[1:].split()[0].decode(), []))
            elif line:
                recs[-1][1].append(line)
    return [(n, np.frombuffer(b"".join(p), dtype=np.uint8).copy())
            for n, p in recs]


def revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of uint8 bases (acgtnACGTN only)."""
    out = _COMP[seq[::-1]]
    if len(seq) and not out.all():
        raise ValueError("a base outside acgtnACGTN")
    return out
