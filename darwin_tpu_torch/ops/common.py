"""Shared constants for the GACT tile kernels.

The values are darwin_tpu/ops/common.py's (that module cannot be
imported without jax).  Op encoding matches the reference (align.h:22):
ZERO=0, DELETE=1, INSERT=2, MATCH=3; direction bytes carry the
"gap-open won" flags 2<<INSERT_OP = 8 and 2<<DELETE_OP = 4, and
MATCH_BIT 16 records char equality at the cell, so rescoring after
traceback needs no sequence gathers.
"""

ZERO_OP, DELETE_OP, INSERT_OP, MATCH_OP = 0, 1, 2, 3
GAP_OPEN_FLAG_I = 2 << INSERT_OP  # 8
GAP_OPEN_FLAG_D = 2 << DELETE_OP  # 4
MATCH_BIT = 16

# Stands in for the reference's -(1<<30) (align.h:18); small enough
# that adding gap penalties cannot wrap int32.
NEG_INF = 1 << 30

# Tile padding bytes: sequences are raw ASCII (>= 33); 1 and 2 never
# match real characters or each other.
PAD_REF = 1
PAD_QUERY = 2
