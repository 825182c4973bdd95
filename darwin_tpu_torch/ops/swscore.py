"""Score-only batched local Smith-Waterman (affine gaps), any length: the
CUDA kernel csrc/swscore.cu, its plain version local_score_batch_torch,
and the dispatch between them.

The port of darwin_tpu/ops/swscore.py::local_score_batch, the exact
scorer of the NPBSS score evaluator (eval/score_eval.py).  Gap
convention as the engine's (align.cpp:129-141): a gap of length g costs
gap_open + (g-1)*gap_extend.
"""

from __future__ import annotations

import torch

from darwin_tpu_torch import _build
from darwin_tpu_torch.ops.common import NEG_INF

I32 = torch.int32
# Warps a block, one block a pair (csrc/swscore.cu kWarps).
WARPS = 8
# Columns a lane holds: the least of SW_STRIPS with one pass over the
# query (csrc/swscore.cu dtt_local_score); wider queries take passes of
# WARPS * 32 * 16 columns.
SW_STRIPS = (2, 4, 6, 8, 12, 16)


def _shift_right(x: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def local_score_batch_torch(ref: torch.Tensor, query: torch.Tensor,
                            ref_len: torch.Tensor, query_len: torch.Tensor,
                            *, match: int, mismatch: int, gap_open: int,
                            gap_extend: int) -> torch.Tensor:
    """Plain PyTorch port of local_score_batch, row by row over all pairs
    at once (the query-gap term a prefix max along the row).

    ref [B, LR] uint8, query [B, LQ] uint8 (zero-padded), ref_len /
    query_len [B] true lengths -> [B] int32 max local score."""
    B, LR = ref.shape
    TJ = query.shape[1] + 1
    dev = ref.device
    qs = torch.cat([torch.zeros((B, 1), dtype=query.dtype, device=dev),
                    query], dim=1)
    jlane = torch.arange(TJ, dtype=I32, device=dev)[None, :]
    jvalid = (jlane >= 1) & (jlane <= query_len.to(I32)[:, None])
    lge = jlane * gap_extend
    m = torch.zeros((B, TJ), dtype=I32, device=dev)
    ins = torch.full((B, TJ), -NEG_INF, dtype=I32, device=dev)
    dl = ins.clone()
    best = torch.zeros(B, dtype=I32, device=dev)
    for i in range(1, LR + 1):
        match_s = torch.where(qs == ref[:, i - 1:i], match, mismatch).to(I32)
        prev3 = torch.maximum(torch.maximum(m, ins), dl)
        m_new = (_shift_right(prev3, 0) + match_s).clamp(min=0)
        m_new[:, 0] = 0
        i_new = torch.maximum(m + gap_open, ins + gap_extend)
        i_new[:, 0] = -NEG_INF
        c = torch.cummax(m_new + gap_open - lge, dim=1).values
        d_new = _shift_right(c, -NEG_INF) + (lge - gap_extend)
        d_new[:, 0] = -NEG_INF
        h = torch.maximum(torch.maximum(m_new, i_new), d_new.clamp(min=0))
        hv = torch.where(jvalid & (i <= ref_len)[:, None], h, 0)
        best = torch.maximum(best, hv.max(dim=1).values)
        m, ins, dl = m_new, i_new, d_new
    return best


def local_score_batch(ref: torch.Tensor, query: torch.Tensor,
                      ref_len: torch.Tensor, query_len: torch.Tensor, *,
                      match: int, mismatch: int, gap_open: int,
                      gap_extend: int) -> torch.Tensor:
    """Same contract as local_score_batch_torch; ref_len / query_len
    must be int32."""
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if ref.device.type == "cpu":
        return local_score_batch_torch(ref, query, ref_len, query_len, **kw)
    dev = _build.require_cuda(ref, "local_score_batch")
    if ref.dim() != 2 or query.dim() != 2:
        raise ValueError("local_score_batch: ref and query must be 2-D")
    B, LR = ref.shape
    LQ = query.shape[1]
    args = [_build.arg(ref, "ref", torch.uint8, (B, LR), dev),
            _build.arg(query, "query", torch.uint8, (B, LQ), dev),
            _build.arg(ref_len, "ref_len", I32, (B,), dev),
            _build.arg(query_len, "query_len", I32, (B,), dev)]
    # The boundary column between passes, for queries wider than one.
    scratch = torch.empty((B, LR + 1, 4), dtype=I32, device=dev)
    best = torch.empty(B, dtype=I32, device=dev)
    if B:
        _build.launch("dtt_local_score", dev, *args, B, LR, LQ, match,
                      mismatch, gap_open, gap_extend, scratch, best)
        local_score_batch.launches += 1
    return best


local_score_batch.launches = 0
