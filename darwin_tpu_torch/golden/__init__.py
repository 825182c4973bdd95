"""Golden executable spec: direct scalar transliterations of the
reference algorithms (align.cpp, seed_pos_table.cpp, gact.cpp).

The port's copy of darwin_tpu/golden/ (numpy only): the oracle the
port's pipeline and device D-SOFT are held to where no JAX runs.

These are intentionally slow and obvious; every production component
(vectorized NumPy, pure-JAX, Pallas) is tested against them, and they in
turn are validated against the reference CPU binary's outputs on the
checked-in fixtures.
"""

from darwin_tpu_torch.golden.align import (D, I, M, Z, align_with_bt)
from darwin_tpu_torch.golden.dsoft import GoldenSeedTable, dsoft_scalar
from darwin_tpu_torch.golden.gact import gact_scalar

__all__ = [
    "Z", "D", "I", "M",
    "align_with_bt", "GoldenSeedTable", "dsoft_scalar", "gact_scalar",
]
