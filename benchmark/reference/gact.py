"""Plain GACT: tiled affine-gap extension of D-SOFT anchors, batched.

Written from Darwin's gact.cpp:48-228 and align.cpp:60-233 (the CPU
build) in plain PyTorch, with no code of the program under test.  Every
call is two halves: the left extension (tiles ending at the anchor, read
forward) and the right one (tiles starting at it, read back to front).
The right half depends on the left one only through the left's first
tile (its re-anchored position, and whether it produced operations), so
it starts as soon as that is known and the two run side by side.  Each
round aligns the next tile of every half that is still extending, all in
one batch:

* The DP runs a tile row by row over all columns at once.  The match
  matrix and the insertion matrix (a gap in the query, read from the row
  above) are elementwise; the deletion matrix along the row is a running
  maximum: D[j] = go + (j-1)ge + max_{k<j} (M[k] - k ge), with M[0] = 0.
  Gap openings read the match matrix (clamped at 0), not H; ties keep
  the reference's order (align.cpp:138-177); the best cell is the last
  one in row-major order with the highest H.
* The traceback follows the direction bytes until a zero cell or until
  either side has taken early_terminate steps.
* The alignment is scored as gact.cpp:197-210 rescores the stitched
  strings: a match or mismatch a column, a gap run open + (len-1) extend,
  with the runs of the two halves merged where both meet the anchor in a
  gap.

A round is some 20,000 small operations, so on a card it is captured
once as a CUDA graph (every row and every traceback step, with no wait
for the device) and replayed each round; on the CPU it runs eagerly and
stops at the longest tile and the last walk.

With saturate=True the cell scores saturate at 127, as 8-bit cells
would: the control that the benchmark's comparison has to reject.
"""

from __future__ import annotations

import numpy as np
import torch

I32, I64 = torch.int32, torch.int64
NEG = -(1 << 30)
Z, D, I, M = 0, 1, 2, 3
INS_BIT, DEL_BIT, MATCH_BIT = 8, 4, 16
RUN, DONE = 1, 2


def tile_round(ref_t: torch.Tensor, qry_t: torch.Tensor,
               rtl: torch.Tensor, qtl: torch.Tensor, first: torch.Tensor,
               p: dict, saturate: bool = False, eager: bool = True):
    """One tile of n halves: the DP, the best cell, the traceback.

    ref_t and qry_t [n, T] in DP order, rtl and qtl their lengths (rows
    and columns), first whether each is its half's first tile.  Returns
    the best cell (max_score, max_i, max_j: read for first tiles only,
    as gact.cpp gates first tiles alone), the traceback's log [n, 2 ET]
    (op | 4 where an M's bases are equal, 0 past the walk) and the steps
    it took on the reference and the query.  eager stops the row loop at
    the longest tile and the walk when every walk has ended; without it
    nothing waits for the device (a CUDA graph replays the same work)."""
    n, T = ref_t.shape
    W = T + 1
    ET = p["tile_size"] - p["tile_overlap"]
    dev = ref_t.device
    ma, mi, go, ge = p["match"], p["mismatch"], p["gap_open"], p["gap_extend"]
    # Two rows of each matrix; column 0 stays M = 0, I = D = -inf.
    Mb = torch.zeros((2, n, W), dtype=I32, device=dev)
    Ib = torch.full((2, n, W), NEG, dtype=I32, device=dev)
    Db = torch.full((2, n, W), NEG, dtype=I32, device=dev)
    dirs = torch.zeros((n, W, W), dtype=torch.uint8, device=dev)
    H = torch.zeros((n, W, W), dtype=torch.int16, device=dev)
    k = torch.arange(T, dtype=I32, device=dev)
    m_shift = -k * ge          # D[j] = go + (j-1)ge + max_k (M[k] - k ge)
    d_base = go + k * ge
    # [mismatch, match], made by kernels alone (a CUDA graph captures no
    # copy from the host).
    score = torch.where(torch.arange(2, device=dev) == 1, ma, mi).to(I32)
    for i in range(1, (int(rtl.max()) if eager else T) + 1):
        Mp, Ip, Dp = Mb[(i - 1) % 2], Ib[(i - 1) % 2], Db[(i - 1) % 2]
        Mc, Ic, Dc = Mb[i % 2], Ib[i % 2], Db[i % 2]
        eq = ref_t[:, i - 1:i] == qry_t
        m, ins, dele = Mc[:, 1:], Ic[:, 1:], Dc[:, 1:]
        torch.maximum(torch.maximum(Mp[:, :-1], Ip[:, :-1]), Dp[:, :-1],
                      out=m)
        m += score[eq.long()]
        m.clamp_(min=0, max=127 if saturate else None)
        ins_open = Mp[:, 1:] + go
        torch.maximum(ins_open, Ip[:, 1:] + ge, out=ins)
        m_left = Mc[:, :-1]
        torch.add(torch.cummax(m_left + m_shift, dim=1).values, d_base,
                  out=dele)
        h = torch.maximum(torch.maximum(m, ins), dele)
        op = torch.where(m >= ins, torch.where(m >= dele, M, D),
                         torch.where(ins >= dele, I, D))
        op.masked_fill_(h <= 0, Z)
        op += ((ins == ins_open) * INS_BIT + (dele == m_left + go) * DEL_BIT
               + eq * MATCH_BIT)
        dirs[:, i, 1:] = op
        H[:, i, 1:] = h.clamp(min=0)
    # The best cell: the highest H, the last in row-major order, among
    # rows 1..rtl and columns 1..qtl.
    ix = torch.arange(W, device=dev)
    ok = ((ix[None, :, None] >= 1) & (ix[None, :, None] <= rtl[:, None, None])
          & (ix[None, None, :] >= 1) & (ix[None, None, :] <= qtl[:, None, None]))
    Hm = torch.where(ok, H, -1).flatten(1)
    del H, ok
    best = Hm.amax(dim=1)
    at = torch.where(Hm == best[:, None],
                     torch.arange(W * W, dtype=I32, device=dev), -1).amax(1)
    del Hm
    best, best_i, best_j = best.long(), (at // W).long(), (at % W).long()
    # The traceback from the best cell (first tiles) or the far corner.
    fail = first & (best < p["first_tile_score_threshold"])
    i_c = torch.where(first, best_i, rtl)
    j_c = torch.where(first, best_j, qtl)
    flat = dirs.view(n, -1)
    cv = flat.gather(1, (i_c * W + j_c)[:, None])[:, 0].long()
    st = torch.where(fail, Z, cv & 3)
    left_r = torch.full_like(rtl, ET)
    left_q = torch.full_like(rtl, ET)
    log = torch.zeros((n, 2 * ET), dtype=torch.uint8, device=dev)
    for step in range(2 * ET):
        go_ = (st != Z) & (torch.minimum(left_r, left_q) > 0)
        if eager and step % 32 == 0 and not bool(go_.any()):
            break
        st = st * go_
        log[:, step] = (st + ((cv & MATCH_BIT) >> 2)) * go_
        mv_r = (st >= I).long()
        mv_q = st & 1
        left_r -= mv_r
        left_q -= mv_q
        i_c -= mv_r
        j_c -= mv_q
        old = cv
        cv = flat.gather(1, (i_c * W + j_c)[:, None])[:, 0].long()
        # M reads the cell it moves to; I and D stay in their gap unless
        # the cell they leave has its gap-open bit.
        nxt = torch.where(st == M, cv & 3, torch.where(
            ((old >> (st + 1)) & 1) == 1, M, st))
        st = nxt * (st != Z)
    return best, best_i, best_j, log, ET - left_r, ET - left_q


class RoundGraph:
    """tile_round for up to nb tiles as one CUDA graph: captured once,
    replayed every round with the round's tiles copied into its static
    inputs (the rest zero-length tiles, which walk no step)."""

    def __init__(self, nb: int, T: int, p: dict, saturate: bool, dev):
        self.ref_t = torch.zeros((nb, T), dtype=torch.int16, device=dev)
        self.qry_t = torch.full((nb, T), -1, dtype=torch.int16, device=dev)
        self.rtl = torch.zeros(nb, dtype=I64, device=dev)
        self.qtl = torch.zeros(nb, dtype=I64, device=dev)
        self.first = torch.zeros(nb, dtype=torch.bool, device=dev)
        args = (self.ref_t, self.qry_t, self.rtl, self.qtl, self.first, p,
                saturate, False)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            tile_round(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = tile_round(*args)

    def __call__(self, ref_t, qry_t, rtl, qtl, first):
        n = len(rtl)
        for dst, src, pad in ((self.ref_t, ref_t, 0), (self.qry_t, qry_t, -1),
                              (self.rtl, rtl, 0), (self.qtl, qtl, 0),
                              (self.first, first, False)):
            dst[:n] = src
            dst[n:] = pad
        self.graph.replay()
        return tuple(x[:n].clone() for x in self.out)


class Halves:
    """Per-half state of every call: index c is call c's left half,
    N + c its right half."""

    def __init__(self, n: int, dev):
        z = lambda dt: torch.zeros(2 * n, dtype=dt, device=dev)  # noqa: E731
        self.rpos, self.qpos = z(I64), z(I64)
        self.first, self.state = z(torch.bool), z(I64)
        self.nmatch, self.nmis, self.gaps, self.runs = (z(I64), z(I64),
                                                        z(I64), z(I64))
        self.prev_gap, self.first_gap, self.has_ops = (
            z(torch.bool), z(torch.bool), z(torch.bool))


def gact(ref_flat: torch.Tensor, ref_start: np.ndarray, ref_len: np.ndarray,
         qry_flat: torch.Tensor, qry_start: np.ndarray, qry_len: np.ndarray,
         piece: np.ndarray, strand: np.ndarray, rpos: np.ndarray,
         qpos: np.ndarray, p: dict, saturate: bool = False,
         max_rounds: int = 100_000, stats: dict | None = None
         ) -> np.ndarray:
    """[N, 5] (ab, ae, bb, be, score) of N GACT calls: anchor (rpos,
    qpos) between reference piece `piece` and query strand `strand`.
    stats, where given, gets the rounds and the tiles aligned."""
    N = len(piece)
    if N == 0:
        return np.zeros((0, 5), dtype=np.int64)
    dev = ref_flat.device
    T, ET = p["tile_size"], p["tile_size"] - p["tile_overlap"]
    thr = p["first_tile_score_threshold"]
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    r_start, r_len = t(ref_start)[t(piece)], t(ref_len)[t(piece)]
    q_start, q_len = t(qry_start)[t(strand)], t(qry_len)[t(strand)]
    r_start, r_len = torch.cat([r_start, r_start]), torch.cat([r_len, r_len])
    q_start, q_len = torch.cat([q_start, q_start]), torch.cat([q_len, q_len])
    h = Halves(N, dev)
    left = torch.arange(2 * N, device=dev) < N
    a_r, a_q = t(rpos), t(qpos)
    h.rpos[:N], h.qpos[:N] = a_r, a_q
    h.first[:N] = True
    h.state[:N] = torch.where((a_r > 0) & (a_q > 0), RUN, DONE)
    rev_r, rev_q = a_r.clone(), a_q.clone()
    spawned = torch.zeros(N, dtype=torch.bool, device=dev)
    cols = torch.arange(T, device=dev)

    def spawn():
        """Start the right half of every call whose left half is done
        or past its first tile."""
        nonlocal spawned
        lst = h.state[:N]
        go = ~spawned & ((lst == DONE) | ~h.first[:N])
        R = torch.nonzero(go)[:, 0] + N
        h.rpos[R], h.qpos[R] = rev_r[R - N], rev_q[R - N]
        h.first[R] = h.first[R - N]
        ok = (h.rpos[R] < r_len[R]) & (h.qpos[R] < q_len[R])
        h.state[R] = torch.where(ok, RUN, DONE)
        spawned = spawned | go

    spawn()
    graph = None
    rounds = tiles = 0
    for rounds in range(max_rounds):
        idx = torch.nonzero(h.state == RUN)[:, 0]
        if idx.numel() == 0:
            break
        tiles += idx.numel()
        lf = left[idx]
        rp, qp = h.rpos[idx], h.qpos[idx]
        rs_, rl_ = r_start[idx], r_len[idx]
        qs_, ql_ = q_start[idx], q_len[idx]
        rtl = torch.where(lf, rp.clamp(max=T), (rl_ - rp).clamp(max=T))
        qtl = torch.where(lf, qp.clamp(max=T), (ql_ - qp).clamp(max=T))
        # Tile bytes in DP order: left tiles forward from pos - len,
        # right tiles back to front from pos + len - 1.
        def tile(flat, start, pos_, tl):
            at = torch.where(lf[:, None], pos_[:, None] - tl[:, None]
                             + cols, pos_[:, None] + tl[:, None] - 1 - cols)
            ok = cols < tl[:, None]
            return torch.where(ok, flat[(start[:, None] + at.clamp(min=0))
                                        .clamp(max=flat.numel() - 1)],
                               0)
        ref_t = tile(ref_flat, rs_, rp, rtl).to(torch.int16)
        qry_t = tile(qry_flat, qs_, qp, qtl).to(torch.int16)
        qry_t = torch.where(cols < qtl[:, None], qry_t, -1)
        first = h.first[idx]
        if graph is None and dev.type == "cuda":
            graph = RoundGraph(2 * N, T, p, saturate, dev)
        run = graph or (lambda *a: tile_round(*a, p, saturate))
        mx, mx_i, mx_j, log, r_steps, q_steps = run(ref_t, qry_t, rtl, qtl,
                                                    first)
        # First tiles re-anchor on the best cell and face the threshold.
        sgn = torch.where(lf, -1, 1)
        rp = torch.where(first, rp + sgn * (rtl - mx_i), rp)
        qp = torch.where(first, qp + sgn * (qtl - mx_j), qp)
        li = idx[lf & first]
        rev_r[li], rev_q[li] = rp[lf & first], qp[lf & first]
        fail = first & (mx < thr)
        # The log's columns in order: ops, then zeros.
        ops = log & 3
        valid = ops != Z
        gap = (ops == I) | (ops == D)
        nm = h.nmatch[idx] + ((ops == M) & (log >= 4)).sum(1)
        nx = h.nmis[idx] + ((ops == M) & (log < 4)).sum(1)
        before = torch.cat([h.prev_gap[idx][:, None], gap[:, :-1]], 1)
        gaps = h.gaps[idx] + gap.sum(1)
        runs = h.runs[idx] + (gap & ~before).sum(1)
        any_ops = valid[:, 0]
        nops = valid.sum(1)
        last_gap = gap.gather(1, (nops - 1).clamp(min=0)[:, None])[:, 0]
        prev_gap = torch.where(any_ops, last_gap, h.prev_gap[idx])
        has_ops = h.has_ops[idx]
        first_gap = torch.where(~has_ops & any_ops, gap[:, 0],
                                h.first_gap[idx])
        has_ops = has_ops | any_ops
        h.nmatch[idx], h.nmis[idx], h.gaps[idx], h.runs[idx] = nm, nx, gaps, runs
        h.prev_gap[idx], h.first_gap[idx], h.has_ops[idx] = (prev_gap,
                                                            first_gap,
                                                            has_ops)
        rp = rp + sgn * torch.where(fail, 0, r_steps)
        qp = qp + sgn * torch.where(fail, 0, q_steps)
        h.rpos[idx], h.qpos[idx] = rp, qp
        first = first & ~any_ops
        h.first[idx] = first
        more = (r_steps > 0) & (q_steps > 0) | first
        more = more & torch.where(lf, (rp > 0) & (qp > 0),
                                  (rp < rl_) & (qp < ql_)) & ~fail
        h.state[idx] = torch.where(more, RUN, DONE)
        spawn()
    else:
        raise RuntimeError(f"GACT did not finish in {max_rounds} rounds")
    if stats is not None:
        stats.update(calls=N, rounds=rounds, tiles=tiles)
    L, R = torch.arange(N, device=dev), torch.arange(N, 2 * N, device=dev)
    ab, bb = h.rpos[L], h.qpos[L]
    runs = h.runs[L] + h.runs[R] - (h.has_ops[L] & h.has_ops[R]
                                    & h.first_gap[L] & h.first_gap[R]).long()
    gaps = h.gaps[L] + h.gaps[R]
    score = (p["match"] * (h.nmatch[L] + h.nmatch[R])
             + p["mismatch"] * (h.nmis[L] + h.nmis[R])
             + p["gap_open"] * runs + p["gap_extend"] * (gaps - runs))
    return torch.stack([ab, h.rpos[R], bb, h.qpos[R], score], 1).cpu().numpy()
