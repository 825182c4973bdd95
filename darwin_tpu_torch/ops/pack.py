"""Traceback words packed from direction bytes, in plain PyTorch.

Ports of darwin_tpu/ops/traceback.py::pack_dir_words and
pack_dir_words6, plus plane2_words, the second word plane of the
plane-2 probe (tools/plane2_probe.py, kernel2).  They are the plain
versions of the DP kernel's fused word formats (ops/dp.py,
dir_format "packed"/"packed6") and of the plane-2 kernel
(ops/plane2.py): the kernels must equal them applied to the byte
matrix.  A dir byte is 5 bits (op 0-3 | openD 4 | openI 8 | MATCH_BIT
16); cells outside the matrix read as 0.
"""

from __future__ import annotations

import torch


def _shifted(d: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """out[:, r, c] = d[:, r - rows, c - cols], 0 where that falls
    outside d; rows >= 0, cols may be -1 (the right neighbour)."""
    B, T, C = d.shape
    out = torch.zeros_like(d)
    if rows < T and abs(cols) < C:
        if cols >= 0:
            out[:, rows:, cols:] = d[:, :T - rows, :C - cols]
        else:
            out[:, rows:, :C + cols] = d[:, :T - rows, -cols:]
    return out


def pack_dir_words(dirm: torch.Tensor) -> torch.Tensor:
    """[B, T, C] uint8 -> [B, T, C] int32 words

    W[r, c] = D[r, c] | D[r, c+1] << 8 | D[r-1, c] << 16 | D[r-1, c+1] << 24.
    """
    d = dirm.to(torch.int32)
    t = d + (_shifted(d, 0, -1) << 8)
    return t + (_shifted(t, 1, 0) << 16)


def pack_dir_words6(dirm: torch.Tensor) -> torch.Tensor:
    """[B, T, C] uint8 -> [B, T, C] int32 words of 5-bit fields

    W[r, c] = D[r, c] | D[r, c+1] << 5 | D[r-1, c] << 10 | D[r-1, c+1] << 15
              | D[r-2, c-1] << 20 | D[r-3, c-2] << 25.
    """
    d = dirm.to(torch.int32)
    t5 = d + (_shifted(d, 0, -1) << 5)
    return (t5 + (_shifted(t5, 1, 0) << 10) + (_shifted(d, 2, 1) << 20)
            + (_shifted(d, 3, 2) << 25))


def plane2_words(dirm: torch.Tensor) -> torch.Tensor:
    """[B, T, C] uint8 -> [B, T, C] int32 second plane of the plane-2
    probe: the deeper diagonal cells

    P[r, c] = D[r-4, c-2] | D[r-5, c-2] << 5 | D[r-6, c-3] << 10.

    (tools/plane2_probe.py:165-180 ages the packed6 history register
    c1c, which holds D[r-3, c-1] at row r, through three more rows and
    one more column shift.)
    """
    d = dirm.to(torch.int32)
    return (_shifted(d, 4, 2) + (_shifted(d, 5, 2) << 5)
            + (_shifted(d, 6, 3) << 10))
