"""Batched GACT tile DP as a plain PyTorch row wavefront.

A port of darwin_tpu/ops/reference_dp.py::align_tiles_jax, the
function the JAX package holds its Pallas kernel against.  Here it is
the plain version of the CUDA kernel in dp.py: the CPU path and the
oracle the kernel is compared with on the card.

One DP row per step (columns across the tensor, tiles down).  The
query-gap in-row recurrence d[j] = max(m[j-1]+go, d[j-1]+ge) uses the
closed form d[j] = (j-1)*ge + cummax_{l<=j-1}(m[l] + go - l*ge); the
max-cell rule (last row-major cell at >=, align.cpp:173-177) becomes a
per-row [row max, largest j attaining it] merged across rows with >=.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from darwin_tpu_torch.ops.common import (GAP_OPEN_FLAG_D, GAP_OPEN_FLAG_I,
                                         MATCH_BIT, NEG_INF)

I32 = torch.int32


def _shift_right(x: torch.Tensor, fill: int) -> torch.Tensor:
    """out[:, j] = x[:, j-1], out[:, 0] = fill."""
    return F.pad(x[:, :-1], (1, 0), value=fill)


def _pick(cond: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """int32 where(cond, a, b) for two Python ints."""
    return cond.to(I32) * (a - b) + b


def align_tiles_torch(ref: torch.Tensor, query: torch.Tensor,
                      ref_len: torch.Tensor, query_len: torch.Tensor,
                      *, match: int, mismatch: int, gap_open: int,
                      gap_extend: int) -> dict:
    """DP over a batch of tiles.

    Args:
      ref, query: [B, T] uint8 tile bytes, already oriented, padded
        with PAD_REF/PAD_QUERY.
      ref_len, query_len: [B] int32 true lengths (0 allowed for idle).

    Returns dict with:
      dir: [B, T, T+1] uint8 direction bytes; row r holds DP row r+1
        (DP row 0 and column 0 are implicitly ZERO).
      max_score, max_i, max_j: [B] int32, 1-indexed row-major-last max
        cell.
      pos_score: [B] int32, H at the anchor corner (ref_len, query_len).
    """
    B, T = ref.shape
    TJ = T + 1
    dev = ref.device
    qs = F.pad(query, (1, 0))  # qs[:, j] = query[:, j-1]
    rl = ref_len.to(I32)
    ql = query_len.to(I32)

    jlane = torch.arange(TJ, dtype=I32, device=dev).expand(B, TJ)
    jvalid = (jlane >= 1) & (jlane <= ql[:, None])
    lge = jlane * gap_extend

    m_prev = torch.zeros((B, TJ), dtype=I32, device=dev)
    i_prev = torch.full((B, TJ), -NEG_INF, dtype=I32, device=dev)
    d_prev = torch.full((B, TJ), -NEG_INF, dtype=I32, device=dev)
    dirm = torch.zeros((B, T, TJ), dtype=torch.uint8, device=dev)
    max_s = torch.zeros(B, dtype=I32, device=dev)
    max_i = torch.zeros_like(max_s)
    max_j = torch.zeros_like(max_s)
    pos_s = torch.zeros_like(max_s)

    for i in range(1, T + 1):
        is_eq = qs == ref[:, i - 1:i]
        match_s = _pick(is_eq, match, mismatch)

        prev3 = torch.maximum(torch.maximum(m_prev, i_prev), d_prev)
        m_new = (_shift_right(prev3, 0) + match_s).clamp_min(0)
        m_new[:, 0] = 0

        ins_open = m_prev + gap_open
        ins_ext = i_prev + gap_extend
        i_new = torch.maximum(ins_open, ins_ext)
        i_new[:, 0] = -NEG_INF

        c = torch.cummax(m_new + gap_open - lge, dim=1).values
        d_new = _shift_right(c, -NEG_INF) + (lge - gap_extend)
        d_new[:, 0] = -NEG_INF

        h_new = torch.maximum(torch.maximum(m_new, i_new),
                              d_new.clamp_min(0))

        del_open = _shift_right(m_new, 0) + gap_open
        del_ext = _shift_right(d_new, -NEG_INF) + gap_extend

        op = torch.where(m_new >= i_new, _pick(m_new >= d_new, 3, 1),
                         _pick(i_new >= d_new, 2, 1))
        op = torch.where((m_new <= 0) & (i_new <= 0) & (d_new <= 0),
                         0, op)
        op = (op + GAP_OPEN_FLAG_I * (ins_open >= ins_ext).to(I32)
              + GAP_OPEN_FLAG_D * (del_open >= del_ext).to(I32)
              + MATCH_BIT * is_eq.to(I32))
        rvalid = (i <= rl)[:, None]
        dirm[:, i - 1] = torch.where(jvalid & rvalid, op, 0).to(torch.uint8)

        hv = torch.where(jvalid, h_new, -1)
        row_max = hv.max(dim=1).values
        row_j = torch.where(hv == row_max[:, None], jlane, -1).max(
            dim=1).values
        upd = (row_max >= max_s) & (i <= rl)
        max_s = torch.where(upd, row_max, max_s)
        max_i = torch.where(upd, i, max_i)
        max_j = torch.where(upd, row_j, max_j)

        corner = torch.where(jlane == ql[:, None], h_new, 0).sum(
            dim=1, dtype=I32)
        pos_s = torch.where(i == rl, corner, pos_s)

        m_prev, i_prev, d_prev = m_new, i_new, d_new

    return dict(dir=dirm, max_score=max_s, max_i=max_i, max_j=max_j,
                pos_score=pos_s)
