"""GACT call and overlap-record types, and the emission threshold.

Copied from darwin_tpu/engine/batch.py (importing that module would
import jax through darwin_tpu.engine).  The host-stepped engine
run_gact_batch is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SCORE_THRESHOLD = 0  # reference gact.cpp:24


@dataclasses.dataclass
class GactCalls:
    """Anchor set produced by D-SOFT (reference GACT_call, gact.h:35)."""
    ref_id: np.ndarray     # chromosome/piece id
    query_id: np.ndarray   # read id
    ref_pos: np.ndarray    # anchor, chromosome-local
    query_pos: np.ndarray

    def __len__(self) -> int:
        return len(self.ref_id)


@dataclasses.dataclass
class OverlapRecord:
    ref_id: int
    query_id: int
    ab: int
    ae: int
    bb: int
    be: int
    score: int
    comp: bool
    # Matched (char-equal) columns; not part of the reference record
    # format.  0 under --noscore.
    nmatch: int = 0
    # Total alignment columns (matches + mismatches + gap columns) =
    # op-stream length.
    ncols: int = 0
