"""D-SOFT with the seed table SHARDED across a mesh.

The port of darwin_tpu/dsoft/sharded_table.py.  For references too large
to replicate, the seed table shards by hash range across the mesh's
devices and candidate hits are exchanged between them (no reference
counterpart: the reference is single-GPU, cuda_host.cu:195).  Per
darwin_tpu's design, with one step a mesh entry (parallel/mesh.py) and
the collectives of parallel/collectives.py between the steps:

(A) the queries are replicated; every entry scans every read's
    minimizers and looks them up in its OWN shard only (shard_scan).
    Shards are aligned to hash boundaries (make_sharded_table), so one
    minimizer's whole position range lives on exactly one entry;
(B) PyTorch, the same code on every device: the occurrences summed over
    the shards (psum), so the kmer-max-occurrence filter and the
    num_seeds cap see global counts; each entry's kept minimizers
    expanded into (read, offset, hit) tuples under one budget for the
    whole batch (tup_max), hit >= offset; the tuples routed to their
    read's owner entry (contiguous read blocks) by an all-gather, or with
    a2a_cap set by an all-to-all of per-destination buckets whose
    overruns flag their reads; the flags OR-ed over the entries; each
    owner's received tuples grouped by read in (offset, hit) order;
(C) per read the tuples sorted by (bin, offset, hit), the segmented
    per-bin counts, the first threshold crossings, and their compaction
    into fixed [R_local, cand_max] rows (shard_count).

shard_scan and shard_count launch csrc/dsoft_sharded.cu on CUDA tensors
and run their plain versions (shard_scan_torch, shard_count_torch) on
CPU tensors; dsoft_table_sharded_torch runs the whole function with the
plain steps on any device.  shard_bounds, make_sharded_table,
DenseShardIndex, make_sharded_dense_index, ShardedBudgets and
derive_budgets are copies of darwin_tpu's host helpers (numpy).
Budget overflows (tuple budget, a2a routing, candidate slots) are
flagged per read; callers fall back to the exact host path for them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from darwin_tpu_torch import _build
from darwin_tpu_torch.dsoft.device import (INT32_MAX, _codes, _lookup,
                                           _query_minimizers_fixed, _u32,
                                           _u32_bits, bucket_directory,
                                           twolevel_lookup)
from darwin_tpu_torch.parallel.collectives import (all_gather, all_to_all,
                                                   por, psum)

_SENTINEL_HASH = np.uint32(0xFFFFFFFF)  # > any 2k-bit hash (k <= 15)
# shard_scan's lookups by index mode (csrc/dsoft_sharded.cu's INDEX).
INDEX_MODES = {"searchsorted": 0, "dense": 1}


# ---- host helpers: copies of darwin_tpu's -----------------------------

def shard_bounds(hashes: np.ndarray, n_shards: int) -> list[int]:
    """Entry-count-balanced split points into a sorted hash array,
    advanced so no hash value spans two shards ([n_shards+1] list)."""
    n = len(hashes)
    bounds = [0]
    for s in range(1, n_shards):
        t = s * n // n_shards
        # advance to the end of the run of equal hashes
        while t < n and t > 0 and hashes[t] == hashes[t - 1]:
            t += 1
        t = max(t, bounds[-1])
        bounds.append(t)
    bounds.append(n)
    return bounds


def make_sharded_table(hashes: np.ndarray, pos: np.ndarray,
                       n_shards: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Split a (hash, pos)-sorted table into hash-aligned shards.

    Returns ([P, Nm] hashes, [P, Nm] pos) padded with a sentinel hash
    that sorts after every real hash, so in-shard searchsorted lookups
    see exactly the shard's ranges.  Split points never bisect a hash
    value: a minimizer resolves on exactly one shard.
    """
    bounds = shard_bounds(hashes, n_shards)
    nm = max(bounds[i + 1] - bounds[i] for i in range(n_shards))
    nm = max(nm, 1)
    h_out = np.full((n_shards, nm), _SENTINEL_HASH, dtype=np.uint32)
    p_out = np.zeros((n_shards, nm), dtype=np.uint32)
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        h_out[s, : hi - lo] = hashes[lo:hi]
        p_out[s, : hi - lo] = pos[lo:hi]
    return h_out, p_out


@dataclasses.dataclass
class DenseShardIndex:
    """Two-level per-shard hash index (make_sharded_dense_index).

    Each shard gets:

    * hd [P, ND] uint32 — its DISTINCT hashes;
    * crs [P, ND+1] int32 — CSR of each distinct hash's pos-range;
    * bkt [P, NB+1] int32 — bucket directory: first distinct-hash
      index with (h - base) >> shift >= b, with a per-shard shift
      sized so every shard fits the uniform NB buckets;
    * base/shift [P] int32, and `steps` = the static number of
      binary-refine iterations (= ceil log2 of the widest bucket).

    Lookup = 2 directory gathers + `steps` refine gathers + 1 verify
    gather.  Memory is O(entries), not O(hash-space).
    """
    hd: np.ndarray
    crs: np.ndarray
    bkt: np.ndarray
    base: np.ndarray
    shift: np.ndarray
    steps: int


def make_sharded_dense_index(h_shards: np.ndarray,
                             bucket_factor: int = 4) -> DenseShardIndex:
    """Build the two-level index for hash-aligned shards (host-side,
    two passes).  bucket_factor ~= buckets per distinct hash; larger =
    fewer refine steps, more memory."""
    P, _ = h_shards.shape
    hds, crss, nds = [], [], []
    bases = np.zeros(P, np.int64)
    spans = np.ones(P, np.int64)
    for s in range(P):
        hs = h_shards[s]
        n = int((hs != _SENTINEL_HASH).sum())
        if n:
            vals, starts = np.unique(hs[:n], return_index=True)
            crs = np.concatenate([starts, [n]]).astype(np.int32)
            bases[s] = int(vals[0])
            spans[s] = int(vals[-1]) - bases[s] + 1
        else:
            vals = np.zeros(0, np.uint32)
            crs = np.zeros(1, np.int32)
        hds.append(vals)
        crss.append(crs)
        nds.append(len(vals))
    ND = max(max(nds), 1)
    NB = max(1, bucket_factor * ND)
    hd = np.full((P, ND), _SENTINEL_HASH, dtype=np.uint32)
    crs_out = np.zeros((P, ND + 1), np.int32)
    bkt = np.zeros((P, NB + 1), np.int32)
    shifts = np.zeros(P, np.int64)
    max_width = 1
    for s in range(P):
        nd = nds[s]
        hd[s, :nd] = hds[s]
        crs_out[s, : nd + 1] = crss[s]
        crs_out[s, nd + 1:] = crss[s][-1] if nd else 0
        shift = 0
        while ((spans[s] - 1) >> shift) >= NB:  # max bucket id <= NB-1
            shift += 1
        shifts[s] = shift
        rel_b = (hds[s].astype(np.int64) - bases[s]) >> shift
        bkt[s] = bucket_directory(rel_b, NB)
        if nd:
            max_width = max(max_width, int(np.diff(bkt[s]).max()))
    steps = max(1, int(np.ceil(np.log2(max_width + 1))))
    return DenseShardIndex(hd, crs_out, bkt, bases.astype(np.int32),
                           shifts.astype(np.int32), steps)


@dataclasses.dataclass
class ShardedBudgets:
    """Workload-derived budgets for dsoft_table_sharded, plus the
    measurements they were derived from (the reference's own fixed
    nz_bins budget, seed_pos_table.h:33, is the precedent for sizing
    these from data instead of guessing)."""
    tup_max: int        # per-device tuple-expansion budget (whole batch)
    cand_max: int       # per-read candidate slots
    a2a_cap: int        # per-(src,dst) all_to_all routing budget
    stats: dict         # observed maxima/means behind the sizing


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def derive_budgets(table, reads, n_shards: int, *, num_seeds_cap: int,
                   threshold: int, max_candidates: int,
                   safety: float = 2.0) -> ShardedBudgets:
    """Derive (tup_max, cand_max, a2a_cap) from the actual workload.

    Replays the D-SOFT gates on the host for each read (minimizer scan
    + table occurrence lookup) and sizes each fixed budget at safety x
    the observed per-slot maximum, rounded up to a power of two:

    * tup_max: per-device tuple expansion is budgeted over the WHOLE
      batch (sum over reads of that shard's occurrences, pre
      hit>=offset filtering);
    * a2a_cap: per-(source shard, read-owner destination) tuple count
      (pre-filter, a conservative superset of the routed tuples);
    * cand_max: per-read candidate count from the host filtration.

    Budget overflow at runtime is still flagged per read, never
    silent; safety covers workload drift from the derivation set.
    """
    from darwin_tpu_torch.coding import query_minimizers
    from darwin_tpu_torch.dsoft.filter import dsoft as host_dsoft

    bounds = np.asarray(shard_bounds(table.hashes, n_shards))
    R = len(reads)
    r_local = -(-R // n_shards)
    per_shard = np.zeros(n_shards, np.int64)            # tuples by src
    sd = np.zeros((n_shards, n_shards), np.int64)       # src x dst
    per_read = np.zeros(R, np.int64)
    cand = np.zeros(R, np.int64)
    for r, read in enumerate(reads):
        offs, hashes = query_minimizers(read, table.k, table.w)
        start, end = table.lookup(hashes)
        occ = end - start
        passing = occ <= table.kmer_max_occurence
        # zero-occurrence minimizers consume num_seeds budget (hence
        # the cumsum over `passing`) but expand to no tuples — and
        # their start index sits past the last shard bound.
        keep = (passing & (np.cumsum(passing) <= num_seeds_cap + 1)
                & (occ > 0))
        src = np.searchsorted(bounds, start[keep], side="right") - 1
        occk = occ[keep]
        np.add.at(per_shard, src, occk)
        np.add.at(sd, (src, np.full(len(src), r // r_local)), occk)
        per_read[r] = occk.sum()
        cand[r] = len(host_dsoft(table, read, num_seeds_cap, threshold,
                                 max_candidates)[0])
    stats = {
        "tuples_per_read_mean": float(per_read.mean()),
        "tuples_per_read_max": int(per_read.max()),
        "tuples_per_shard_max": int(per_shard.max()),
        "tuples_src_dst_max": int(sd.max()),
        "cand_per_read_mean": float(cand.mean()),
        "cand_per_read_max": int(cand.max()),
        "n_reads": R, "n_shards": n_shards,
    }
    return ShardedBudgets(
        tup_max=_next_pow2(int(safety * max(1, per_shard.max()))),
        cand_max=_next_pow2(int(safety * max(1, cand.max()))),
        a2a_cap=_next_pow2(int(safety * max(1, sd.max()))),
        stats=stats)


# ---- the shards on the mesh --------------------------------------------

def place_shards(mesh, hash_shards: np.ndarray, pos_shards: np.ndarray,
                 dindex: DenseShardIndex | None = None) -> list:
    """Each mesh entry's shard on its device, as dsoft_table_sharded
    takes them: [(hashes [Nm], positions [Nm], dense index or None)], the
    uint32 arrays as int32 bit patterns, the dense index as (hd, crs,
    bkt, base [1], shift [1])."""
    out = []
    for s, dev in enumerate(mesh.devices):
        di = None
        if dindex is not None:
            di = tuple(_u32_bits(a[s], dev) for a in (
                dindex.hd, dindex.crs, dindex.bkt))
            di += tuple(_u32_bits(a[s:s + 1], dev)
                        for a in (dindex.base, dindex.shift))
        out.append((_u32_bits(hash_shards[s], dev),
                    _u32_bits(pos_shards[s], dev), di))
    return out


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of int64 uint32 values."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


# ---- (A) the scan and the shard's lookups -------------------------------

def shard_scan_torch(queries, qlens, th, dindex=None, *, k: int, w: int,
                     index: str = "searchsorted", dense_steps: int = 0):
    """The plain version of shard_scan: darwin_tpu's minimizer scan of
    every read and each emitted minimizer's range in this shard (its
    sorted hashes th, or with index="dense" its DenseShardIndex slices
    dindex).  Returns (emit [R, LP] bool, start and occ [R, LP] int32, 0
    where nothing is emitted), LP = L + 16."""
    R, L = queries.shape
    LP = L + 16
    emit, _, mhash = _query_minimizers_fixed(_codes(queries, qlens, LP),
                                             qlens, k, w)
    if index == "dense":
        start, end = twolevel_lookup(mhash, *dindex, steps=dense_steps)
    elif index == "searchsorted":
        start, end = _lookup(mhash, th, "searchsorted", 0)
    else:
        raise ValueError(f"index {index!r}: searchsorted or dense")
    return (emit, torch.where(emit, start, 0).to(torch.int32),
            torch.where(emit, end - start, 0).to(torch.int32))


def shard_scan(queries, qlens, th, dindex=None, *, k: int, w: int,
               index: str = "searchsorted", dense_steps: int = 0):
    """Step (A) of one shard: queries [R, L] uint8, qlens [R] int32, the
    shard's place_shards entry.  CPU tensors take shard_scan_torch; CUDA
    tensors launch csrc/dsoft_sharded.cu's shard_scan (one block a
    read)."""
    kw = dict(k=k, w=w, index=index, dense_steps=dense_steps)
    if queries.device.type == "cpu":
        return shard_scan_torch(queries, qlens, th, dindex, **kw)
    dev = _build.require_cuda(queries, "shard_scan")
    if index not in INDEX_MODES:
        raise ValueError(f"index {index!r}: searchsorted or dense")
    if queries.dim() != 2 or not (3 < k <= 15 and 1 <= w < k
                                  and 0 <= dense_steps <= 32):
        raise ValueError(f"shard_scan: queries {tuple(queries.shape)}, "
                         f"k={k}, w={w}, dense_steps={dense_steps}")
    R, L = queries.shape
    LP = L + 16
    I32 = torch.int32
    args = [_build.arg(queries, "queries", torch.uint8, (R, L), dev),
            _build.arg(qlens, "qlens", I32, (R,), dev)]
    empty = torch.zeros(2, dtype=I32, device=dev)
    if index == "dense":
        hd, crs, bkt, base, shift = dindex
        nh, nb = hd.shape[0], bkt.shape[0] - 1
        idx = [_build.arg(hd, "hd", I32, (nh,), dev),
               _build.arg(crs, "crs", I32, (nh + 1,), dev),
               _build.arg(bkt, "bkt", I32, (nb + 1,), dev),
               _build.arg(base, "base", I32, (1,), dev),
               _build.arg(shift, "shift", I32, (1,), dev)]
    else:
        nh, nb = th.shape[0] if th.dim() == 1 else -1, 1
        idx = [_build.arg(th, "th", I32, (nh,), dev), empty, empty, empty,
               empty]
    emit = torch.empty((R, LP), dtype=torch.bool, device=dev)
    start = torch.empty((R, LP), dtype=I32, device=dev)
    occ = torch.empty((R, LP), dtype=I32, device=dev)
    _build.launch("dtt_shard_scan", dev, *args, R, L, LP, *idx, nh, nb,
                  dense_steps if index == "dense" else 0, k, w,
                  INDEX_MODES[index], emit, start, occ)
    if R:
        shard_scan.launches += 1
    return emit, start, occ


shard_scan.launches = 0


# ---- (C) the owner's per-read counts -------------------------------------

def shard_count_torch(hit, off, seg, *, k: int, bin_size: int,
                      threshold: int, max_candidates: int, cand_max: int):
    """The plain version of shard_count: darwin_tpu's sort by (read,
    bin, offset, hit), segmented counts, first crossings and per-read
    compaction, over a shard's received tuples hit (uint32 bit patterns)
    and off [N] int32, grouped by read in (offset, hit) order, read r's
    at seg[r] .. seg[r+1] (seg [R_local + 1] int64).  Returns (hits
    [R_local, cand_max] int32 bit patterns, -1 after each read's count;
    offs [R_local, cand_max] int32, -1 after it; counts [R_local] int32;
    over_c [R_local] bool: min(crossings, max_candidates) > cand_max)."""
    dev = hit.device
    R = seg.numel() - 1
    s0, s1 = int(seg[0]), int(seg[-1])
    read = torch.repeat_interleave(torch.arange(R, device=dev),
                                   seg[1:] - seg[:-1])
    h = _u32(hit[s0:s1])
    o = off[s0:s1].long()
    q = (h - o) // bin_size  # uint32 quotient (hit >= offset)
    bins = torch.where(q >= 2 ** 31, q - 2 ** 32, q)  # its int32 view
    # Stable by (read, bin) over the (read, offset, hit) order: JAX's
    # stable four-key sort (rloc, bin, mpos, hit).
    order = torch.sort(read * 2 ** 32 + bins + 2 ** 31, stable=True).indices
    r_s, b_s, m_s = read[order], bins[order], o[order]
    seg_start = torch.ones_like(r_s, dtype=torch.bool)
    seg_start[1:] = (r_s[1:] != r_s[:-1]) | (b_s[1:] != b_s[:-1])
    delta = torch.zeros_like(m_s)
    delta[1:] = m_s[1:] - m_s[:-1]
    inc = torch.where(seg_start, k, delta.clamp(max=k))
    cum2 = torch.cumsum(inc, 0)
    seg_base = torch.cummax(torch.where(seg_start, cum2 - inc, -1), 0).values
    crossing = cum2 - seg_base >= threshold
    prev_cross = torch.zeros_like(crossing)
    prev_cross[1:] = crossing[:-1]
    fc = torch.zeros_like(crossing)
    fc[order] = crossing & ~(prev_cross & ~seg_start)
    # The first crossings in (read, offset, hit) order, the first cand_max
    # of each read.
    idx = torch.nonzero(fc).flatten()
    c_r = read[idx]
    n_emit = torch.bincount(c_r, minlength=R)
    crank = (torch.arange(idx.numel(), device=dev)
             - (torch.cumsum(n_emit, 0) - n_emit)[c_r])
    n_final = n_emit.clamp(max=max_candidates).clamp(max=cand_max)
    put = crank < n_final[c_r]
    hits = torch.full((R, cand_max), -1, dtype=torch.int32, device=dev)
    offs = torch.full((R, cand_max), -1, dtype=torch.int32, device=dev)
    hits[c_r[put], crank[put]] = hit[s0 + idx[put]]
    offs[c_r[put], crank[put]] = off[s0 + idx[put]]
    return (hits, offs, n_final.to(torch.int32),
            n_emit.clamp(max=max_candidates) > cand_max)


def shard_count(hit, off, seg, *, k: int, bin_size: int, threshold: int,
                max_candidates: int, cand_max: int):
    """Step (C) of one shard, shard_count_torch's contract.  CPU tensors
    take the plain version; CUDA tensors launch csrc/dsoft_sharded.cu's
    shard_count (a read at a time: in registers, in shared memory or, past
    the shared-memory budget, in a scratch area of device memory sized
    from the tuple count N alone), with no host sync.  Since no read's
    length is known on the host, every call with N past the
    shared-memory budget (22752 tuples) allocates that scratch,
    dtt_shard_count_scratch_bytes(N) = r16(8N) + r16(N), about 9N bytes
    beside the 8N of hit and off, whether or not a read needs it.  Raises
    for N * k at or past 2^31."""
    kw = dict(k=k, bin_size=bin_size, threshold=threshold,
              max_candidates=max_candidates, cand_max=cand_max)
    if hit.device.type == "cpu":
        return shard_count_torch(hit, off, seg, **kw)
    dev = _build.require_cuda(hit, "shard_count")
    if not (k >= 1 and bin_size >= 1 and cand_max >= 1):
        raise ValueError(f"shard_count: k={k}, bin_size={bin_size}, "
                         f"cand_max={cand_max}")
    N, R = hit.shape[0], seg.shape[0] - 1
    if N * k >= 2 ** 31:
        raise ValueError(f"shard_count: {N} tuples at k={k}")
    I32 = torch.int32
    args = [_build.arg(hit, "hit", I32, (N,), dev),
            _build.arg(off, "off", I32, (N,), dev),
            _build.arg(seg, "seg", torch.int64, (R + 1,), dev)]
    need = _build.host_call("dtt_shard_count_scratch_bytes", N)
    scratch = torch.empty(max(need, 16), dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hits = torch.empty((R, cand_max), dtype=I32, device=dev)
    offs = torch.empty((R, cand_max), dtype=I32, device=dev)
    counts = torch.empty(R, dtype=I32, device=dev)
    over = torch.empty(R, dtype=torch.bool, device=dev)
    _build.launch("dtt_shard_count", dev, *args, R, N, k, bin_size,
                  threshold, max_candidates, cand_max, sms, scratch, hits,
                  offs, counts, over)
    if R:
        shard_count.launches += 1
    return hits, offs, counts, over


shard_count.launches = 0


# ---- the whole function -----------------------------------------------

def dsoft_table_sharded(mesh, queries, qlens, shards, *, k: int, w: int,
                        bin_size: int, kmer_max_occ: int, num_seeds_cap: int,
                        threshold: int, max_candidates: int,
                        tup_max: int = 8192, cand_max: int = 512,
                        a2a_cap: int | None = None,
                        index: str = "searchsorted", dense_steps: int = 0,
                        steps=None, mark=None):
    """Table-sharded D-SOFT over mesh (darwin_tpu's
    dsoft_table_sharded_fn(mesh, ...)(queries, qlens, ...)).

    queries [R, L] uint8 and qlens [R] int32 on any device, R a multiple
    of the mesh size; shards: place_shards' list (index "dense" needs its
    dense index and dense_steps = DenseShardIndex.steps).  a2a_cap None
    exchanges the tuples by an all-gather, a number by an all-to-all with
    that per-destination budget.  steps: the (scan, count) pair, by
    default the kernels' wrappers (dsoft_table_sharded_torch passes the
    plain versions).  mark, when given, is called with a step's name as
    each step ends, on the host in launch order: "scan" after each
    entry's scan, "tuples" after the tuple expansion (step B), "exchange",
    then for each owner "group" after its grouping sorts and "count"
    (chip_smoke.py's phase 9 records a CUDA event at each).  Returns
    (hits [R, cand_max] int64: uint32 values,
    0xFFFFFFFF beyond counts; offsets [R, cand_max] int32, -1 beyond
    counts; counts [R] int32; overflow [R] bool) on the mesh's first
    device."""
    scan, count = steps or (shard_scan, shard_count)
    mark = mark or (lambda step: None)
    P = mesh.size
    R, L = queries.shape
    if R % P:
        raise ValueError(f"dsoft_table_sharded: {R} reads, no multiple of "
                         f"the mesh size {P}")
    if index not in INDEX_MODES or len(shards) != P:
        raise ValueError(f"dsoft_table_sharded: index {index!r}, "
                         f"{len(shards)} shards on a mesh of {P}")
    LP = L + 16
    R_local = R // P
    devs = mesh.devices

    # (A) every read's minimizers, looked up in each shard.
    scans = []
    for d, (th, _, di) in zip(devs, shards):
        scans.append(scan(queries.to(d), qlens.to(d), th, di, k=k, w=w,
                          index=index, dense_steps=dense_steps))
        mark("scan")
    occ_g = psum([occ for _, _, occ in scans])

    # (B) the tuples of each shard's kept minimizers under tup_max.
    sent, flags = [], []
    for (emit, start, occ_l), og, (_, tp, _) in zip(scans, occ_g, shards):
        dev = emit.device
        passing = emit & (og <= kmer_max_occ)
        rank = torch.cumsum(passing.long(), dim=1)
        keep = passing & (rank <= num_seeds_cap + 1)
        counts_l = torch.where(keep, occ_l, 0).reshape(-1).long()
        cum = torch.cumsum(counts_l, 0)
        # A read overflowed locally iff its tuple range [begin, end) has
        # tuples and extends past the budget.
        read_end = cum.reshape(R, LP)[:, -1]
        read_begin = torch.cat([read_end.new_zeros(1), read_end[:-1]])
        overflow_read = (read_end > tup_max) & (read_end > read_begin)
        t_idx = torch.arange(tup_max, device=dev)
        f = torch.searchsorted(cum, t_idx, right=True).clamp(max=R * LP - 1)
        within = t_idx - (cum[f] - counts_l[f])
        tvalid = t_idx < cum[-1].clamp(max=tup_max)
        g_idx = torch.where(tvalid, start.reshape(-1).long()[f] + within, 0)
        hit = _u32(tp)[g_idx]  # uint32 positions, carried in int64
        t_read, t_mpos = f // LP, f % LP
        tvalid &= hit >= t_mpos  # seed_pos_table.cpp:135
        r_valid = torch.where(tvalid, t_read, INT32_MAX)
        if a2a_cap is None:
            sent.append((r_valid, t_mpos, hit))
        else:
            # Routed to the read's owner entry only, at most a2a_cap
            # tuples from each source to each owner; overruns flag their
            # reads.
            owner = torch.where(tvalid, t_read // R_local, P)
            o_s, perm = torch.sort(owner, stable=True)
            r2, m2, h2 = r_valid[perm], t_mpos[perm], hit[perm]
            v2 = o_s != P
            onew = v2.clone()
            onew[1:] &= o_s[1:] != o_s[:-1]
            orank = t_idx - torch.cummax(torch.where(onew, t_idx, -1),
                                         0).values
            dropped = v2 & (orank >= a2a_cap)
            overflow_read[r2[dropped]] = True
            put2 = v2 & ~dropped
            tgt2 = torch.where(put2, o_s * a2a_cap + orank, P * a2a_cap)

            def route(vals, fill, put2=put2, tgt2=tgt2):
                buf = vals.new_full((P * a2a_cap + 1,), fill)
                buf[tgt2] = torch.where(put2, vals, fill)
                return buf[:-1].reshape(P, a2a_cap)

            sent.append((route(r2, INT32_MAX), route(m2, 0), route(h2, 0)))
        flags.append(overflow_read)
    mark("tuples")

    # The exchange.
    exchange = all_gather if a2a_cap is None else all_to_all
    a_read, a_mpos, a_hit = (exchange([s[j] for s in sent])
                             for j in range(3))
    overflow = por(flags)
    mark("exchange")

    # (C) each owner's reads: its tuples grouped by read in (offset, hit)
    # order (a stable sort by hit, then by read and offset), then counted.
    outs = []
    for d in range(P):
        base = d * R_local
        ar, am, ah = a_read[d], a_mpos[d], a_hit[d]
        mine = (ar >= base) & (ar < base + R_local)
        by_hit = torch.sort(ah, stable=True).indices
        key = torch.where(mine, (ar - base) * LP + am, R_local * LP)[by_hit]
        key_s, o2 = torch.sort(key, stable=True)
        perm = by_hit[o2]
        seg = torch.searchsorted(
            key_s, torch.arange(R_local + 1, device=key_s.device) * LP)
        mark("group")
        hits, offs, cnt, over_c = count(
            _bits32(ah[perm]), am[perm].to(torch.int32), seg, k=k,
            bin_size=bin_size, threshold=threshold,
            max_candidates=max_candidates, cand_max=cand_max)
        mark("count")
        outs.append((_u32(hits), offs, cnt,
                     overflow[d][base:base + R_local] | over_c))
    return tuple(torch.cat([o[j].to(devs[0]) for o in outs])
                 for j in range(4))


def dsoft_table_sharded_torch(mesh, queries, qlens, shards, **kw):
    """dsoft_table_sharded with the plain versions of its two steps, on
    whatever devices the mesh holds: darwin_tpu's body step for step."""
    return dsoft_table_sharded(mesh, queries, qlens, shards,
                               steps=(shard_scan_torch, shard_count_torch),
                               **kw)
