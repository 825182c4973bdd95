"""Runtime parameters and INI config loading.

The port's copy of darwin_tpu/config.py.  Mirrors the reference's
``params.cfg`` key set (reference: params.cfg:1-23, ConfigFile.cpp:30-65)
but as a typed dataclass rather than a stringly-typed map.  Defaults
equal the reference defaults.
"""

from __future__ import annotations

import configparser
import dataclasses
from pathlib import Path


@dataclasses.dataclass
class Params:
    # GACT scoring (reference params.cfg:1-5)
    match: int = 1
    mismatch: int = -1
    gap_open: int = -1
    gap_extend: int = -1

    # D-SOFT (reference params.cfg:7-15)
    seed_size: int = 14          # k-mer size, 3 < k <= 15, k > window_size
    bin_size: int = 64           # diagonal band width
    window_size: int = 4         # minimizer window
    threshold: int = 21          # D-SOFT matched-bases threshold per bin
    num_seeds: int = 800         # cap on query minimizers used
    seed_occurence_multiple: int = 32
    max_candidates: int = 1_000_000
    num_nz_bins: int = 2_500_000

    # GACT first tile (reference params.cfg:17-19).  first_tile_size is
    # parsed by the reference but never used (darwin.cpp:487); kept for
    # config compatibility.
    first_tile_size: int = 128
    first_tile_score_threshold: int = 35

    # GACT extension (reference params.cfg:21-23)
    tile_size: int = 320
    tile_overlap: int = 120

    @property
    def early_terminate(self) -> int:
        """Max traceback steps per tile (reference darwin.cpp:611)."""
        return self.tile_size - self.tile_overlap

    def __post_init__(self) -> None:
        if not (3 < self.seed_size <= 15):
            raise ValueError("seed_size must satisfy 3 < k <= 15")
        if self.seed_size <= self.window_size:
            raise ValueError("seed_size must be > window_size")
        if self.bin_size & (self.bin_size - 1):
            raise ValueError("bin_size must be a power of two")

    @classmethod
    def from_cfg(cls, path: str | Path) -> "Params":
        """Load from a reference-compatible params.cfg INI file."""
        cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        with open(path) as f:
            cp.read_file(f)

        def val(section: str, key: str, default: int) -> int:
            try:
                return int(float(cp.get(section, key)))
            except (configparser.NoSectionError, configparser.NoOptionError):
                return default

        d = cls()
        return cls(
            match=val("GACT_scoring", "match", d.match),
            mismatch=val("GACT_scoring", "mismatch", d.mismatch),
            gap_open=val("GACT_scoring", "gap_open", d.gap_open),
            gap_extend=val("GACT_scoring", "gap_extend", d.gap_extend),
            seed_size=val("DSOFT_params", "seed_size", d.seed_size),
            bin_size=val("DSOFT_params", "bin_size", d.bin_size),
            window_size=val("DSOFT_params", "window_size", d.window_size),
            threshold=val("DSOFT_params", "threshold", d.threshold),
            num_seeds=val("DSOFT_params", "num_seeds", d.num_seeds),
            seed_occurence_multiple=val(
                "DSOFT_params", "seed_occurence_multiple",
                d.seed_occurence_multiple),
            max_candidates=val(
                "DSOFT_params", "max_candidates", d.max_candidates),
            num_nz_bins=val("DSOFT_params", "num_nz_bins", d.num_nz_bins),
            first_tile_size=val(
                "GACT_first_tile", "first_tile_size", d.first_tile_size),
            first_tile_score_threshold=val(
                "GACT_first_tile", "first_tile_score_threshold",
                d.first_tile_score_threshold),
            tile_size=val("GACT_extend", "tile_size", d.tile_size),
            tile_overlap=val("GACT_extend", "tile_overlap", d.tile_overlap),
        )
