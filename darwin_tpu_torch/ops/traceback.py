"""Traceback over a batch of direction matrices: the CUDA walker
csrc/traceback.cu, its plain version traceback_torch, and the
dispatch between them.

Semantics of AlignWithBT's traceback loop (reference
align.cpp:185-231), as darwin_tpu/ops/traceback.py::traceback_jax
implements them: walk from the start cell until a ZERO op or until
either axis has consumed early_terminate steps; INSERT moves up (ref
axis), DELETE moves left (query axis), and their "gap-open won" flag at
the *current* cell switches the next state to MATCH.

Both versions return the op stream dense and in walk order as ONE
[B, 2*ET-1] uint8 array holding op | MATCH_BIT (MATCH_BIT on MATCH ops
whose chars were equal), so ``raw & 3`` and ``raw >= MATCH_BIT`` are
traceback_jax's ops and mbits, transposed.
"""

from __future__ import annotations

import torch

from darwin_tpu_torch import _build
from darwin_tpu_torch.ops.common import (GAP_OPEN_FLAG_D, GAP_OPEN_FLAG_I,
                                         MATCH_BIT)

I32 = torch.int32


def traceback_torch(dirm: torch.Tensor, ref_len: torch.Tensor,
                    query_len: torch.Tensor, first: torch.Tensor,
                    max_i: torch.Tensor, max_j: torch.Tensor, *,
                    early_terminate: int):
    """Plain PyTorch walker, all tiles in lockstep.

    Args:
      dirm: [B, T, C] uint8 direction matrices; row r holds DP row r+1
        (DP row 0 and column 0 read as ZERO).
      ref_len, query_len: [B] int32 anchor cell of non-first tiles.
      first: [B] bool; first tiles start at (max_i, max_j).

    Returns (raw [B, 2*ET-1] uint8, i_steps [B] int32, j_steps [B]
    int32).
    """
    B, T, C = dirm.shape
    ET = early_terminate
    S = 2 * ET - 1
    flat = dirm.reshape(B, T * C)

    def cell(i, j):
        idx = (i - 1).clamp(0, T - 1) * C + j.clamp(0, C - 1)
        v = flat.gather(1, idx[:, None].long())[:, 0].to(I32)
        return torch.where((i >= 1) & (j >= 1), v, 0)

    i = torch.where(first, max_i, ref_len).to(I32)
    j = torch.where(first, max_j, query_len).to(I32)
    val = cell(i, j)
    state = val & 3
    raw = torch.zeros((B, S), dtype=torch.uint8, device=dirm.device)
    i_steps = torch.zeros(B, dtype=I32, device=dirm.device)
    j_steps = torch.zeros_like(i_steps)
    for s in range(S):
        active = (state != 0) & (i_steps < ET) & (j_steps < ET)
        if not bool(active.any()):
            break
        is_m = state == 3
        is_i = state == 2
        rec = state + torch.where(is_m, val & MATCH_BIT, 0)
        raw[:, s] = torch.where(active, rec, 0).to(torch.uint8)
        di = (is_m | is_i).to(I32) * active
        dj = (~is_i).to(I32) * active
        i = i - di
        j = j - dj
        nval = cell(i, j)
        nxt = torch.where(
            is_m, nval & 3,
            torch.where(is_i,
                        torch.where((val & GAP_OPEN_FLAG_I) != 0, 3, 2),
                        torch.where((val & GAP_OPEN_FLAG_D) != 0, 3, 1)))
        state = torch.where(active, nxt, state)
        val = torch.where(active, nval, val)
        i_steps = i_steps + di
        j_steps = j_steps + dj
    return raw, i_steps, j_steps


def traceback(dirm: torch.Tensor, ref_len: torch.Tensor,
              query_len: torch.Tensor, first: torch.Tensor,
              max_i: torch.Tensor, max_j: torch.Tensor, *,
              early_terminate: int):
    """Same contract as traceback_torch; dirm must be [B, T, T+1] (the
    DP kernel's layout)."""
    if dirm.device.type == "cpu":
        return traceback_torch(dirm, ref_len, query_len, first, max_i,
                               max_j, early_terminate=early_terminate)
    dev = _build.require_cuda(dirm, "traceback")
    if dirm.dim() != 3:
        raise ValueError(f"traceback: dirm must be [B, T, T+1], got "
                         f"{tuple(dirm.shape)}")
    B, T = dirm.shape[:2]
    ET = early_terminate
    if ET < 1:
        raise ValueError(f"traceback: early_terminate {ET} < 1")
    i32 = torch.int32
    args = [_build.arg(dirm, "dirm", torch.uint8, (B, T, T + 1), dev),
            _build.arg(ref_len, "ref_len", i32, (B,), dev),
            _build.arg(query_len, "query_len", i32, (B,), dev),
            _build.arg(first, "first", torch.bool, (B,), dev),
            _build.arg(max_i, "max_i", i32, (B,), dev),
            _build.arg(max_j, "max_j", i32, (B,), dev)]
    raw = torch.empty((B, 2 * ET - 1), dtype=torch.uint8, device=dev)
    i_steps = torch.empty(B, dtype=i32, device=dev)
    j_steps = torch.empty(B, dtype=i32, device=dev)
    if B:
        _build.launch("dtt_traceback", dev, *args, B, T, ET,
                      raw.data_ptr(), i_steps.data_ptr(),
                      j_steps.data_ptr())
        traceback.launches += 1
    return raw, i_steps, j_steps


traceback.launches = 0
