"""Traceback over a batch of direction matrices: three walkers, each a
CUDA kernel with its plain PyTorch version and the dispatch between
them.

* traceback (csrc/traceback.cu; plain traceback_torch) walks dir bytes,
  the port of darwin_tpu/ops/traceback.py::traceback_jax, one warp a
  tile over shared-memory windows of the matrix;
* traceback_packed (csrc/traceback_words.cu; plain
  traceback_packed_torch) walks pack_dir_words words, two steps a
  gather: traceback_packed_jax;
* traceback_packed6 (csrc/traceback_words.cu; plain
  traceback_packed6_torch) walks pack_dir_words6 words, two to four
  steps a gather: traceback_packed6_jax; both word walkers also one warp
  a tile over shared-memory windows, of words.

Semantics of AlignWithBT's traceback loop (reference
align.cpp:185-231), as the JAX walkers implement them: walk from the
start cell until a ZERO op or until either axis has consumed
early_terminate steps; INSERT moves up (ref axis), DELETE moves left
(query axis), and their "gap-open won" flag at the *current* cell
switches the next state to MATCH.

Every walker returns its op stream in walk order as ONE [B, width]
uint8 array holding op | MATCH_BIT (MATCH_BIT on MATCH ops whose chars
were equal), so ``raw & 3`` and ``raw >= MATCH_BIT`` are the JAX
walker's ops and mbits, transposed.  The byte and packed walkers'
streams are dense, 2*ET-1 wide; the packed6 walker's is the JAX one
slot for slot, holes included.
"""

from __future__ import annotations

import torch

from darwin_tpu_torch import _build
from darwin_tpu_torch.ops.common import (GAP_OPEN_FLAG_D, GAP_OPEN_FLAG_I,
                                         MATCH_BIT)

I32 = torch.int32
# The word walkers' format codes in csrc/traceback_words.cu.
WORD_FORMATS = {"packed": 1, "packed6": 2}


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
    args = [_build.arg(dirm, "dirm", torch.uint8, (B, T, T + 1), dev),
            _build.arg(ref_len, "ref_len", I32, (B,), dev),
            _build.arg(query_len, "query_len", I32, (B,), dev),
            _build.arg(first, "first", torch.bool, (B,), dev),
            _build.arg(max_i, "max_i", I32, (B,), dev),
            _build.arg(max_j, "max_j", I32, (B,), dev)]
    raw = torch.empty((B, 2 * ET - 1), dtype=torch.uint8, device=dev)
    i_steps = torch.empty(B, dtype=I32, device=dev)
    j_steps = torch.empty(B, dtype=I32, device=dev)
    if B:
        _build.launch("dtt_traceback", dev, *args, B, T, ET, raw, i_steps,
                      j_steps)
        traceback.launches += 1
    return raw, i_steps, j_steps


traceback.launches = 0


# ---- the word walkers ------------------------------------------------

def _resolve(pstate, pval, cur):
    """State on entering a cell, from the state/byte of the cell left: a
    MATCH takes the entered cell's op bits; INSERT/DELETE turn into
    MATCH when the left cell carries their gap-open-won flag."""
    return torch.where(
        pstate == 3, cur & 3,
        torch.where(
            pstate == 2,
            torch.where((pval & GAP_OPEN_FLAG_I) != 0, 3, 2),
            torch.where(pstate == 1,
                        torch.where((pval & GAP_OPEN_FLAG_D) != 0, 3, 1),
                        0)))


def _word_gather(flat: torch.Tensor, T: int, C: int):
    """gather(i, j): the [B] words at (i-1, j-1) of flat [B, T*C],
    coordinates clipped into the matrix, 0 where i < 1 or j < 1."""
    def gather(i, j):
        idx = (i - 1).clamp(0, T - 1) * C + (j - 1).clamp(0, C - 1)
        w = flat.gather(1, idx[:, None].long())[:, 0]
        return torch.where((i >= 1) & (j >= 1), w, 0)
    return gather


def _start(ref_len, query_len, first, max_i, max_j) -> list:
    """Walker state [pstate, pval, i, j, i_steps, j_steps]: pstate MATCH
    with pval 0 makes the first resolve yield the start cell's own op
    bits."""
    i = torch.where(first, max_i, ref_len).to(I32)
    j = torch.where(first, max_j, query_len).to(I32)
    return [torch.full_like(i, 3), torch.zeros_like(i), i, j,
            torch.zeros_like(i), torch.zeros_like(i)]


def _pending(walker: list, ET: int) -> torch.Tensor:
    pstate, _, _, _, i_steps, j_steps = walker
    return (pstate != 0) & (i_steps < ET) & (j_steps < ET)


def _substep(state, val, have, i, j, i_steps, j_steps, v_next, have_next,
             ET):
    """One walk step at (i, j), whose state/byte are (state, val) where
    `have`: records the op, moves, and chains to the entered cell's
    (state, val) only where its byte v_next is in the word
    (`have_next`); elsewhere the state keeps describing this cell and
    the next gather resolves the entered one.  traceback_packed6_jax's
    substep (traceback.py:238-262)."""
    act = have & (state != 0) & (i_steps < ET) & (j_steps < ET)
    rec = torch.where(act, state + torch.where(state == 3, val & MATCH_BIT,
                                               0), 0)
    is_m = state == 3
    is_i = state == 2
    di = (is_m | is_i).to(I32) * act
    dj = (~is_i).to(I32) * act
    ni, nj = i - di, j - dj
    v_next = torch.where((ni >= 1) & (nj >= 1), v_next, 0)
    upd = act & have_next
    n_val = torch.where(upd, v_next, val)
    n_state = torch.where(upd, _resolve(state, val, v_next), state)
    return rec, is_m, n_state, n_val, upd, ni, nj, i_steps + di, j_steps + dj


def traceback_packed_torch(words: torch.Tensor, ref_len: torch.Tensor,
                           query_len: torch.Tensor, first: torch.Tensor,
                           max_i: torch.Tensor, max_j: torch.Tensor, *,
                           early_terminate: int, unroll: int = 1):
    """Plain PyTorch port of traceback_packed_jax, all tiles in lockstep:
    one gather at (i-1, j-1) of the pack_dir_words words [B, T, C]
    yields the current cell and its three move targets, so each
    iteration walks two steps; `unroll` pairs run between termination
    checks.  The stream is dense and the same for every unroll.

    Returns (raw [B, 2*ET-1] uint8, i_steps [B] int32, j_steps [B]
    int32), as traceback_torch."""
    if unroll < 1:
        raise ValueError(f"traceback_packed: unroll {unroll} < 1")
    B, T, C = words.shape
    ET = early_terminate
    S = 2 * ET - 1
    SP = -(-(S + 1) // (2 * unroll)) * (2 * unroll)
    gather = _word_gather(words.reshape(B, T * C), T, C)
    walker = _start(ref_len, query_len, first, max_i, max_j)
    yes = torch.ones(B, dtype=torch.bool, device=words.device)
    raw = torch.zeros((B, SP), dtype=torch.uint8, device=words.device)
    s = 0
    while s + 1 < SP and bool(_pending(walker, ET).any()):
        for _ in range(unroll):
            pstate, pval, i, j, i_steps, j_steps = walker
            w = gather(i, j)
            val = (w >> 8) & 0xFF
            state = _resolve(pstate, pval, val)
            moved = torch.where(state == 3, (w >> 16) & 0xFF,
                                torch.where(state == 2, (w >> 24) & 0xFF,
                                            w & 0xFF))
            rec_a, _, st1, v1, _, i1, j1, is1, js1 = _substep(
                state, val, yes, i, j, i_steps, j_steps, moved, yes, ET)
            rec_b, _, st2, v2, _, i2, j2, is2, js2 = _substep(
                st1, v1, yes, i1, j1, is1, js1, val, ~yes, ET)
            raw[:, s] = rec_a.to(torch.uint8)
            raw[:, s + 1] = rec_b.to(torch.uint8)
            s += 2
            walker = [st2, v2, i2, j2, is2, js2]
    return raw[:, :S].contiguous(), walker[4], walker[5]


def packed6_width(shape: tuple, early_terminate: int,
                  compact_b: int) -> int:
    """Slots of traceback_packed6's op stream over words of `shape`
    (B, T, C): 4-slot groups of 2-4 ops, SP = 4 * ceil((S + 1) / 2) for
    S = 2*ET-1, plus one spare group when compaction is on
    (traceback.py:195-203)."""
    S = 2 * early_terminate - 1
    SP = 4 * (-(-(S + 1) // 2))
    return SP + 4 if _compact_lanes(shape, compact_b) else SP


def _compact_lanes(shape: tuple, compact_b: int) -> int:
    """compact_b where compaction is on (0 < compact_b < B and the flat
    words fit int32 indexing), else 0."""
    B, T, C = shape
    return compact_b if 0 < compact_b < B and B * T * C < 2 ** 31 else 0


def _group6(gather, walker: list, ET: int):
    """One gather and up to four walk steps (traceback_packed6_jax's
    step): steps A and B as the packed walker; B chains only on the MM
    diagonal, C only on MMM, D never (the carry keeps cell 3's
    state/byte).  Returns ([B, 4] op records, walker)."""
    pstate, pval, i, j, i_steps, j_steps = walker
    w = gather(i, j)
    val = (w >> 5) & 31
    state = _resolve(pstate, pval, val)
    yes = torch.ones_like(state, dtype=torch.bool)
    vb1 = torch.where(state == 3, (w >> 10) & 31,
                      torch.where(state == 2, (w >> 15) & 31, w & 31))
    rec_a, is_m_a, st1, v1, h1, i1, j1, is1, js1 = _substep(
        state, val, yes, i, j, i_steps, j_steps, vb1, yes, ET)
    rec_b, _, st2, v2, h2, i2, j2, is2, js2 = _substep(
        st1, v1, h1, i1, j1, is1, js1, (w >> 20) & 31, is_m_a & (st1 == 3),
        ET)
    rec_c, _, st3, v3, h3, i3, j3, is3, js3 = _substep(
        st2, v2, h2, i2, j2, is2, js2, (w >> 25) & 31, st2 == 3, ET)
    rec_d, _, st4, v4, _, i4, j4, is4, js4 = _substep(
        st3, v3, h3, i3, j3, is3, js3, val, ~yes, ET)
    group = torch.stack([rec_a, rec_b, rec_c, rec_d], dim=1)
    return group.to(torch.uint8), [st4, v4, i4, j4, is4, js4]


def _walk6(gather, walker: list, ops: torch.Tensor, stop_at: int, ET: int):
    """Groups into ops[:, 0:4], [4:8], ... while more than stop_at lanes
    are pending; returns (walker, next slot)."""
    s = 0
    while s + 1 < ops.shape[1] and int(_pending(walker, ET).sum()) > stop_at:
        ops[:, s:s + 4], walker = _group6(gather, walker, ET)
        s += 4
    return walker, s


def traceback_packed6_torch(words: torch.Tensor, ref_len: torch.Tensor,
                            query_len: torch.Tensor, first: torch.Tensor,
                            max_i: torch.Tensor, max_j: torch.Tensor, *,
                            early_terminate: int, compact_b: int = 0):
    """Plain PyTorch port of traceback_packed6_jax, all tiles in
    lockstep, over pack_dir_words6 words [B, T, C]: each iteration
    writes one 4-slot group of 2-4 ops a lane, so lanes carry trailing
    zero slots inside their groups.  With compaction on (packed6_width),
    the full-width loop stops once at most compact_b lanes are pending,
    and those finish alone, their groups after the first phase's; the
    output is the same slot for slot.

    Returns (raw [B, packed6_width] uint8 holding op | MATCH_BIT,
    i_steps [B] int32, j_steps [B] int32)."""
    B, T, C = words.shape
    ET = early_terminate
    K = _compact_lanes(words.shape, compact_b)
    flat = words.reshape(B, T * C)
    ops = torch.zeros((B, packed6_width(words.shape, ET, compact_b)),
                      dtype=torch.uint8, device=words.device)
    walker, s = _walk6(_word_gather(flat, T, C),
                       _start(ref_len, query_len, first, max_i, max_j), ops,
                       K, ET)
    pending = _pending(walker, ET)
    if K and bool(pending.any()):
        sel = pending.nonzero()[:, 0]
        tail = torch.zeros((len(sel), ops.shape[1]), dtype=torch.uint8,
                           device=words.device)
        sub, _ = _walk6(_word_gather(flat[sel], T, C),
                        [x[sel] for x in walker], tail, 0, ET)
        ops[sel] |= torch.roll(tail, s, dims=1)
        walker[4][sel] = sub[4]
        walker[5][sel] = sub[5]
    return ops, walker[4], walker[5]


def _walk_words(fmt: str, words, ref_len, query_len, first, max_i, max_j,
                ET: int, width: int, what: str):
    """Launch csrc/traceback_words.cu on CUDA tensors (the caller counts
    the launch)."""
    dev = _build.require_cuda(words, what)
    if words.dim() != 3:
        raise ValueError(f"{what}: words must be [B, T, T+1], got "
                         f"{tuple(words.shape)}")
    if ET < 1:
        raise ValueError(f"{what}: early_terminate {ET} < 1")
    B, T = words.shape[:2]
    args = [_build.arg(words, "words", I32, (B, T, T + 1), dev),
            _build.arg(ref_len, "ref_len", I32, (B,), dev),
            _build.arg(query_len, "query_len", I32, (B,), dev),
            _build.arg(first, "first", torch.bool, (B,), dev),
            _build.arg(max_i, "max_i", I32, (B,), dev),
            _build.arg(max_j, "max_j", I32, (B,), dev)]
    raw = torch.empty((B, width), dtype=torch.uint8, device=dev)
    i_steps = torch.empty(B, dtype=I32, device=dev)
    j_steps = torch.empty(B, dtype=I32, device=dev)
    if B:
        _build.launch("dtt_traceback_words", dev, *args, B, T, ET,
                      WORD_FORMATS[fmt], width, raw, i_steps, j_steps)
    return raw, i_steps, j_steps


def traceback_packed(words: torch.Tensor, ref_len: torch.Tensor,
                     query_len: torch.Tensor, first: torch.Tensor,
                     max_i: torch.Tensor, max_j: torch.Tensor, *,
                     early_terminate: int, unroll: int = 1):
    """Same contract as traceback_packed_torch; words must be
    [B, T, T+1] int32 (the DP kernel's "packed" layout).  The kernel
    walks each tile on its own warp, so `unroll`, which only spaces the
    lockstep loop's termination checks, does not change it."""
    if words.device.type == "cpu":
        return traceback_packed_torch(words, ref_len, query_len, first,
                                      max_i, max_j,
                                      early_terminate=early_terminate,
                                      unroll=unroll)
    if unroll < 1:
        raise ValueError(f"traceback_packed: unroll {unroll} < 1")
    out = _walk_words("packed", words, ref_len, query_len, first, max_i,
                      max_j, early_terminate, 2 * early_terminate - 1,
                      "traceback_packed")
    if words.shape[0]:
        traceback_packed.launches += 1
    return out


def traceback_packed6(words: torch.Tensor, ref_len: torch.Tensor,
                      query_len: torch.Tensor, first: torch.Tensor,
                      max_i: torch.Tensor, max_j: torch.Tensor, *,
                      early_terminate: int, compact_b: int = 0):
    """Same contract as traceback_packed6_torch; words must be
    [B, T, T+1] int32 (the DP kernel's "packed6" layout).  The kernel
    gives compaction's output width, but each warp retires on its own,
    so there is nothing to compact."""
    if words.device.type == "cpu":
        return traceback_packed6_torch(words, ref_len, query_len, first,
                                       max_i, max_j,
                                       early_terminate=early_terminate,
                                       compact_b=compact_b)
    out = _walk_words("packed6", words, ref_len, query_len, first, max_i,
                      max_j, early_terminate,
                      packed6_width(words.shape, early_terminate, compact_b),
                      "traceback_packed6")
    if words.shape[0]:
        traceback_packed6.launches += 1
    return out


traceback_packed.launches = 0
traceback_packed6.launches = 0

# dir_format -> (the align_tiles output its walker reads, the walker).
WALKERS = {"bytes": ("dir", traceback),
           "packed": ("dir_words", traceback_packed),
           "packed6": ("dir_words", traceback_packed6)}
