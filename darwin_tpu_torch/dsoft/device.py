"""Device D-SOFT: the whole read batch seeded in one launch.

The port of darwin_tpu/dsoft/device.py (same names, arguments and
outputs).  D-SOFT (reference seed_pos_table.cpp:100-167; executable spec
golden/dsoft.py) per read-strand: the minimizer scan, the seed-table
lookup of each emitted minimizer, the num_seeds cap, the expansion of
the kept minimizers into (hit, offset) tuples under a fixed tuple
budget, a stable sort of the tuples by bin, the per-bin count as a
segmented prefix sum and each bin's first threshold crossing, and the
first crossings in emission order under a fixed candidate budget, with
an overflow flag where a budget truncated.

* dsoft_device_batch launches csrc/dsoft.cu on CUDA tensors (one block a
  read-strand) and runs dsoft_device_batch_torch, the plain PyTorch
  version (darwin_tpu's _dsoft_one with its vmap written out as a
  leading [R] dimension), on CPU tensors;
* make_twolevel_index, bucket_directory, default_index_mode and
  pad_reads are darwin_tpu's host helpers (numpy), with their outputs;
  make_twolevel_index and bucket_directory build from the runs of their
  sorted input, where darwin_tpu sorts the table again and counts every
  bucket;
* device_index puts a seed table's index and positions on a device in
  the layout dsoft_device_batch takes;
* sharded_dsoft splits the reads in blocks over a mesh, the index
  replicated on every mesh entry, one dsoft_device_batch call a block
  (darwin_tpu's sharded_dsoft_fn).

uint32 data (hashes, positions) travels as its int32 bit pattern
(torch.int32 tensors; torch.uint32 lacks most ops); the hits come back
as int64 holding the uint32 value, 0xFFFFFFFF beyond each read's count,
so ``hits.numpy().astype(np.uint32)`` is darwin_tpu's array.  Bytes of a
row at and after its qlen read as code 0 (pad_reads zero-fills them for
darwin_tpu, which codes them as they are).
"""

from __future__ import annotations

import numpy as np
import torch

from darwin_tpu_torch import _build

INT32_MAX = np.iinfo(np.int32).max
UINT32_FILL = 0xFFFFFFFF  # hits padding
# The kernel's lookups by index mode (csrc/dsoft.cu's INDEX).
INDEX_MODES = {"searchsorted": 0, "dense": 1, "twolevel": 2}


def _codes(queries: torch.Tensor, qlens: torch.Tensor, LP: int):
    """[R, LP] int64 2-bit codes (A/C/G/T either case 0-3, other bytes
    0), zero at and after each row's qlen."""
    q = queries.long() | 0x20
    c = torch.where(q == ord("c"), 1, torch.where(
        q == ord("g"), 2, torch.where(q == ord("t"), 3, 0)))
    R, L = queries.shape
    col = torch.arange(L, device=queries.device)
    c = torch.where(col[None, :] < qlens.long()[:, None], c, 0)
    return torch.nn.functional.pad(c, (0, LP - L))


def _hash32(key: torch.Tensor, k: int) -> torch.Tensor:
    """Thomas Wang hash masked to 2k bits (ntcoding.cpp:74-85), on int64
    tensors holding uint32 values: every right shift acts on a masked
    value, so the low 2k bits are the uint32 arithmetic's."""
    m = (1 << (2 * k)) - 1
    key = (~key + (key << 21)) & m
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & m
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & m
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & m
    return key


def _query_minimizers_fixed(codes: torch.Tensor, qlens: torch.Tensor,
                            k: int, w: int):
    """The minimizer scan of every row as fixed-shape masked arrays
    (darwin_tpu's _query_minimizers_fixed over a leading [R]).

    codes: [R, LP] int64, zero beyond each read.  Returns (emit [R, LP]
    bool, pos [LP] int64, mhash [R, LP] int64): emit marks the emitted
    minimizers at scan position p, mhash the window minimum there."""
    R, LP = codes.shape
    pos = torch.arange(LP, device=codes.device)
    seed = torch.zeros_like(codes)
    for t in range(k):
        seed = seed | (torch.roll(codes, -t, dims=1) << (2 * t))
    h = _hash32(seed, k)
    m = h
    for s in range(1, w):
        m = torch.minimum(m, torch.roll(h, s, dims=1))
    # Scan range: lo = w-1, hi = 16*ceil(len/16) - k - w
    # (QTwoBitToMinimizers convention, ntcoding.cpp:155-182).
    hi = 16 * ((qlens.long() + 15) // 16) - k - w
    lo = w - 1
    in_range = (pos[None, :] >= lo) & (pos[None, :] < hi[:, None])
    prev_m = torch.roll(m, 1, dims=1)
    prev_m[:, lo] = 0  # initial last_m = 0
    change = (m != prev_m) & in_range
    # Each change point anchors a run; the first run is anchored at the
    # virtual p = 0: the anchor of p is the last change at or before it.
    anchor = torch.cummax(torch.where(change, pos[None, :], 0), dim=1).values
    offset = pos[None, :] - anchor
    emit = (change | ((offset % w == 0) & (offset > 0))) & in_range
    return emit, pos, m


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values of a tensor of uint32 bit patterns (int32 storage)."""
    return t.long() & 0xFFFFFFFF


def twolevel_lookup(hv, hd, crs, bkt, base, shift, *, steps: int):
    """(start, end) pos-table ranges of the hashes hv (int64 uint32
    values, any shape) through a two-level index (make_twolevel_index's
    hd, crs, bkt, base, shift as tensors: hd the int32 bit patterns of
    its uint32 values; base and shift [1]): bucket-directory gathers
    narrow the search to <= 2^steps distinct hashes, a fixed-step binary
    refine and one verify gather finish it.  Absent hashes resolve to
    (0, 0).  darwin_tpu's twolevel_lookup."""
    hdv = _u32(hd)
    ND = hd.shape[0]
    NB = bkt.shape[0] - 1
    rel = hv - base.long()[0]
    b = rel.clamp(min=0) >> int(shift[0])
    bvalid = (rel >= 0) & (b < NB)
    bc = b.clamp(max=NB - 1)
    bktl = bkt.long()
    lo, hi = bktl[bc], bktl[bc + 1]
    for _ in range(steps):
        act = lo < hi
        mid = (lo + hi) >> 1
        less = hdv[mid.clamp(0, ND - 1)] < hv
        lo = torch.where(act & less, mid + 1, lo)
        hi = torch.where(act & ~less, mid, hi)
    d = lo.clamp(max=ND - 1)
    found = bvalid & (lo < ND) & (hdv[d] == hv)
    crsl = crs.long()
    return (torch.where(found, crsl[d], 0),
            torch.where(found, crsl[d + 1], 0))


def _lookup(mhash, table_hashes, index: str, tl_steps: int):
    """(start, end) of every mhash, by index mode."""
    if index == "dense":
        csr = table_hashes.long()
        return csr[mhash], csr[mhash + 1]
    if index == "twolevel":
        return twolevel_lookup(mhash, *table_hashes, steps=tl_steps)
    if index != "searchsorted":
        raise ValueError(f"index {index!r}: searchsorted, dense or twolevel")
    hs = _u32(table_hashes)
    flat = mhash.reshape(-1)
    return (torch.searchsorted(hs, flat).reshape(mhash.shape),
            torch.searchsorted(hs, flat, right=True).reshape(mhash.shape))


def dsoft_device_batch_torch(queries, qlens, table_hashes, table_pos, *,
                             k: int, w: int, bin_size: int,
                             kmer_max_occ: int, num_seeds_cap: int,
                             threshold: int, max_candidates: int,
                             tup_max: int = 8192, cand_max: int = 512,
                             index: str = "searchsorted", tl_steps: int = 0):
    """The plain PyTorch version of dsoft_device_batch, all rows in
    lockstep: darwin_tpu's _dsoft_one under vmap, step for step."""
    dev = queries.device
    R, L = queries.shape
    LP = L + 16  # headroom so k-mer reads past the scan range see zeros
    emit, pos, mhash = _query_minimizers_fixed(_codes(queries, qlens, LP),
                                               qlens, k, w)
    start, end = _lookup(mhash, table_hashes, index, tl_steps)
    occ = end - start
    passing = emit & (occ <= kmer_max_occ)
    rank = torch.cumsum(passing.long(), dim=1)
    # The first num_seeds_cap+1 passing minimizers are processed
    # (check-before-increment, seed_pos_table.cpp:128-131).
    keep = passing & (rank <= num_seeds_cap + 1)
    counts = torch.where(keep, occ, 0)
    cum = torch.cumsum(counts, dim=1)
    total = cum[:, -1]
    overflow = total > tup_max

    # Slot t belongs to the kept minimizer m with cum[m]-counts[m] <= t
    # < cum[m]: the first m with cum[m] > t.
    t_idx = torch.arange(tup_max, device=dev)
    mz = torch.searchsorted(cum, t_idx.expand(R, tup_max).contiguous(),
                            right=True).clamp(max=LP - 1)
    within = t_idx[None, :] - (cum.gather(1, mz) - counts.gather(1, mz))
    tup_valid = t_idx[None, :] < total.clamp(max=tup_max)[:, None]
    gather_idx = torch.where(tup_valid, start.gather(1, mz) + within, 0)
    # Positions are uint32 end to end (seed_pos_table.cpp's pos width).
    tpos = _u32(table_pos) if table_pos.numel() else torch.zeros(
        1, dtype=torch.long, device=dev)
    hit = tpos[gather_idx.clamp(0, tpos.shape[0] - 1)]
    toff = pos[mz]
    tup_valid &= hit >= toff  # seed_pos_table.cpp:135
    q = (hit - toff).clamp(min=0) // bin_size  # uint32 quotient
    q = torch.where(q >= 2 ** 31, q - 2 ** 32, q)  # its int32 view
    bins = torch.where(tup_valid, q, INT32_MAX)
    b_s, t_s = torch.sort(bins, dim=1, stable=True)
    h_s = hit.gather(1, t_s)
    o_s = toff.gather(1, t_s)
    v_s = tup_valid.gather(1, t_s)

    seg_start = torch.ones_like(v_s)
    seg_start[:, 1:] = b_s[:, 1:] != b_s[:, :-1]
    seg_start &= v_s
    delta = torch.zeros_like(o_s)
    delta[:, 1:] = o_s[:, 1:] - o_s[:, :-1]
    inc = torch.where(v_s, torch.where(seg_start, k, delta.clamp(max=k)), 0)
    cum2 = torch.cumsum(inc, dim=1)
    # Segment base = cum2 - inc at the segment start, forward-filled.
    base_at = torch.where(seg_start, cum2 - inc, -1)
    seg_base = torch.cummax(base_at, dim=1).values
    count = cum2 - seg_base
    crossing = (count >= threshold) & v_s
    prev_cross = torch.zeros_like(crossing)
    prev_cross[:, 1:] = crossing[:, :-1]
    first_cross = crossing & ~(prev_cross & ~seg_start)

    # Back to emission (tuple) order; the first cand_max.
    emit_key = torch.where(first_cross, t_s, INT32_MAX)
    e_perm = torch.sort(emit_key, dim=1, stable=True).indices
    e_h = h_s.gather(1, e_perm)
    e_o = o_s.gather(1, e_perm)
    if tup_max < cand_max:  # tiny tuple budgets: pad to the slice size
        pad = (0, cand_max - tup_max)
        e_h = torch.nn.functional.pad(e_h, pad, value=UINT32_FILL)
        e_o = torch.nn.functional.pad(e_o, pad, value=-1)
    n_emit = first_cross.sum(dim=1)
    n = n_emit.clamp(max=max_candidates).clamp(max=cand_max)
    # Overflow only where the fixed budget truncates below the semantic
    # cap (truncation at max_candidates itself is correct behavior).
    overflow |= n_emit.clamp(max=max_candidates) > cand_max
    cand_valid = torch.arange(cand_max, device=dev)[None, :] < n[:, None]
    return (torch.where(cand_valid, e_h[:, :cand_max], UINT32_FILL),
            torch.where(cand_valid, e_o[:, :cand_max], -1).to(torch.int32),
            n.to(torch.int32), overflow)


def dsoft_device_batch(queries, qlens, table_hashes, table_pos, *,
                       k: int, w: int, bin_size: int, kmer_max_occ: int,
                       num_seeds_cap: int, threshold: int,
                       max_candidates: int, tup_max: int = 8192,
                       cand_max: int = 512, index: str = "searchsorted",
                       tl_steps: int = 0):
    """Batched device D-SOFT (darwin_tpu's dsoft_device_batch).

    queries: [R, L] uint8 ASCII, qlens: [R] int32.  table_hashes by
    index: "searchsorted" the sorted hashes [N] (int32 bit patterns);
    "dense" dense_hash_index's CSR [4^k + 1] int32; "twolevel" the
    first five make_twolevel_index arrays as tensors (device_index), with
    tl_steps its steps.  table_pos: [N] positions (int32 bit patterns).

    Returns (hits [R, cand_max] int64: uint32 values, 0xFFFFFFFF beyond
    counts; offsets [R, cand_max] int32, -1 beyond counts; counts [R]
    int32; overflow [R] bool).  CPU tensors take the plain version;
    CUDA tensors launch csrc/dsoft.cu."""
    kw = dict(k=k, w=w, bin_size=bin_size, kmer_max_occ=kmer_max_occ,
              num_seeds_cap=num_seeds_cap, threshold=threshold,
              max_candidates=max_candidates, tup_max=tup_max,
              cand_max=cand_max, index=index, tl_steps=tl_steps)
    if queries.device.type == "cpu":
        return dsoft_device_batch_torch(queries, qlens, table_hashes,
                                        table_pos, **kw)
    return _launch(queries, qlens, table_hashes, table_pos, **kw)


dsoft_device_batch.launches = 0


def _launch(queries, qlens, table_hashes, table_pos, *, k, w, bin_size,
            kmer_max_occ, num_seeds_cap, threshold, max_candidates, tup_max,
            cand_max, index, tl_steps):
    dev = _build.require_cuda(queries, "dsoft_device_batch")
    if queries.dim() != 2:
        raise ValueError(f"dsoft_device_batch: queries must be [R, L], got "
                         f"{tuple(queries.shape)}")
    if index not in INDEX_MODES:
        raise ValueError(f"index {index!r}: searchsorted, dense or twolevel")
    if not (3 < k <= 15 and 1 <= w < k and bin_size >= 1
            and 1 <= tup_max < 2 ** 30 and tup_max * k < 2 ** 31
            and cand_max >= 1
            and 0 <= num_seeds_cap < 2 ** 31 and 0 <= tl_steps <= 32):
        raise ValueError(f"dsoft_device_batch: k={k}, w={w}, bin_size="
                         f"{bin_size}, num_seeds_cap={num_seeds_cap}, "
                         f"tup_max={tup_max}, cand_max={cand_max}, "
                         f"tl_steps={tl_steps} out of range")
    R, L = queries.shape
    I32 = torch.int32
    args = [_build.arg(queries, "queries", torch.uint8, (R, L), dev),
            _build.arg(qlens, "qlens", I32, (R,), dev)]
    n_pos = table_pos.shape[0] if table_pos.dim() == 1 else -1
    tpos = _build.arg(table_pos, "table_pos", I32, (n_pos,), dev)
    empty = torch.zeros(2, dtype=I32, device=dev)
    if index == "twolevel":
        hd, crs, bkt, base, shift = table_hashes
        nd, nb = hd.shape[0], bkt.shape[0] - 1
        idx = [_build.arg(hd, "hd", I32, (nd,), dev),
               _build.arg(crs, "crs", I32, (nd + 1,), dev),
               _build.arg(bkt, "bkt", I32, (nb + 1,), dev),
               _build.arg(base, "base", I32, (1,), dev),
               _build.arg(shift, "shift", I32, (1,), dev)]
        nh = nd
    elif index == "dense":
        nh = 1 << (2 * k)
        idx = [empty, _build.arg(table_hashes, "csr", I32, (nh + 1,), dev),
               empty, empty, empty]
        nb = 1
    else:
        nh = table_hashes.shape[0] if table_hashes.dim() == 1 else -1
        idx = [_build.arg(table_hashes, "table_hashes", I32, (nh,), dev),
               empty, empty, empty, empty]
        nb = 1
    hits = torch.empty((R, cand_max), dtype=torch.int64, device=dev)
    offs = torch.empty((R, cand_max), dtype=I32, device=dev)
    counts = torch.empty(R, dtype=I32, device=dev)
    overflow = torch.empty(R, dtype=torch.bool, device=dev)
    if R == 0:
        return hits, offs, counts, overflow
    # The device memory the kernels need beside the outputs (the list of
    # reads past the shared-memory tuple budget, the large path's
    # scratch), as csrc/dsoft.cu sizes it: 0 for tup_max within the
    # budget.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    need = _build.host_call("dtt_dsoft_scratch_bytes", R, tup_max,
                            num_seeds_cap, sms)
    scratch = (torch.empty(need, dtype=torch.uint8, device=dev) if need
               else empty)
    _build.launch("dtt_dsoft", dev, *args, R, L, *idx, nh, nb, tl_steps,
                  tpos, k, w, bin_size, kmer_max_occ, num_seeds_cap,
                  threshold, max_candidates, tup_max, cand_max,
                  INDEX_MODES[index], sms, scratch, hits, offs, counts,
                  overflow)
    dsoft_device_batch.launches += 1
    return hits, offs, counts, overflow


def sharded_dsoft(mesh, queries, qlens, table_hashes, table_pos, **kw):
    """D-SOFT with the reads sharded over mesh (parallel/mesh.Mesh) and
    the seed table replicated (darwin_tpu's sharded_dsoft_fn(mesh,
    ...)(queries, qlens, ...)): block i of R / size reads is one
    dsoft_device_batch call on mesh entry i, with that entry's index
    table_hashes[i] and positions table_pos[i] (device_index's, on its
    device).  R must be a multiple of the mesh size; kw is
    dsoft_device_batch's.  Returns its four outputs over all R reads on
    the mesh's first device."""
    R, P = queries.shape[0], mesh.size
    if R % P:
        raise ValueError(f"sharded_dsoft: {R} reads, no multiple of the "
                         f"mesh size {P}")
    b = R // P
    outs = [dsoft_device_batch(queries[i * b:(i + 1) * b].to(d),
                               qlens[i * b:(i + 1) * b].to(d), th, tp, **kw)
            for i, (d, th, tp) in enumerate(zip(mesh.devices, table_hashes,
                                                table_pos))]
    return tuple(torch.cat([o[j].to(mesh.devices[0]) for o in outs])
                 for j in range(4))


# ---- the seed table's index on a device -------------------------------

def _u32_bits(a: np.ndarray, device) -> torch.Tensor:
    """A uint32 (or int32) numpy array as an int32 tensor of the same
    bits on device."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).astype(np.uint32).view(np.int32))).to(device)


def dense_hash_index(table_hashes: torch.Tensor, k: int) -> torch.Tensor:
    """CSR index over the full 4^k hash space: csr[h] = number of table
    entries with hash < h (start = csr[h], end = csr[h+1]); [4^k + 1]
    int32 on table_hashes' device, by bincount and cumsum
    (darwin_tpu's dense_hash_index, the reference's index_table_,
    seed_pos_table.cpp:73-94)."""
    n = 1 << (2 * k)
    counts = torch.bincount(_u32(table_hashes) + 1, minlength=n + 1)
    return torch.cumsum(counts[:n + 1], 0).to(torch.int32)


def device_index(hashes: np.ndarray, pos: np.ndarray, *, k: int, index: str,
                 device, twolevel=None):
    """(table_hashes, table_pos, tl_steps) of a seed table (its sorted
    uint32 hashes and positions) for dsoft_device_batch on device.
    twolevel: make_twolevel_index's result, if already built."""
    tpos = _u32_bits(pos, device)
    if index == "twolevel":
        tl = make_twolevel_index(hashes) if twolevel is None else twolevel
        th = tuple(_u32_bits(a, device) for a in tl[:5])
        return th, tpos, tl[5]
    th = _u32_bits(hashes, device)
    if index == "dense":
        return dense_hash_index(th, k), tpos, 0
    if index != "searchsorted":
        raise ValueError(f"index {index!r}: searchsorted, dense or twolevel")
    return th, tpos, 0


# ---- host helpers: darwin_tpu's, with their outputs -----------------------

def _run_starts(a: np.ndarray) -> np.ndarray:
    """Where each run of equal values of a sorted array starts (0 first;
    none in an empty array)."""
    if len(a) == 0:
        return np.zeros(0, np.int64)
    return np.concatenate([[0], np.flatnonzero(a[1:] != a[:-1]) + 1])


def _directory(ids: np.ndarray, first: np.ndarray, n: int,
               NB: int) -> np.ndarray:
    """bucket_directory from its occupied buckets: ids ascending, the
    index of each one's first entry, n entries in all.  The ids after
    one occupied bucket, up to the next one's, take the next one's first
    entry: one pass over the output."""
    gaps = np.diff(np.concatenate([[-1], ids, [NB]]))
    return np.repeat(np.append(first, n).astype(np.int32), gaps)


def bucket_directory(rel_b: np.ndarray, NB: int) -> np.ndarray:
    """[NB+1] int32 directory: bkt[i] = #entries with bucket id < i.

    Equivalent to np.searchsorted(rel_b, np.arange(NB + 1)) for sorted
    rel_b in [0, NB), but built from rel_b's runs in O(n) work and one
    pass over the output."""
    first = _run_starts(rel_b)
    return _directory(rel_b[first], first, len(rel_b), NB)


def make_twolevel_index(hashes: np.ndarray, bucket_factor: int = 8):
    """Two-level index over ONE sorted hash array: (hd, crs, bkt, base,
    shift, steps) — the distinct hashes, their CSR starts, a bucket
    directory of bucket_factor buckets a distinct hash over the hash
    span, and the binary-refine steps the widest bucket needs.  The
    hashes arrive sorted, so the distinct hashes, the occupied buckets
    and the widest one come from runs (np.unique's result without its
    sort), in passes over the table and one over the directory."""
    n = len(hashes)
    if n == 0:
        return (np.full(1, 0xFFFFFFFF, np.uint32),
                np.zeros(2, np.int32), np.zeros(2, np.int32),
                np.zeros(1, np.int32), np.zeros(1, np.int32), 1)
    starts = _run_starts(hashes)
    vals = hashes[starts]
    crs = np.empty(len(starts) + 1, np.int32)
    crs[:-1] = starts
    crs[-1] = n
    base = int(vals[0])
    span = int(vals[-1]) - base + 1
    nd = len(vals)
    NB = max(1, bucket_factor * nd)
    shift = 0
    while ((span - 1) >> shift) >= NB:
        shift += 1
    rel_b = (vals - vals[0]) >> shift
    first = _run_starts(rel_b)
    bkt = _directory(rel_b[first], first, nd, NB)
    max_width = int(np.diff(np.append(first, nd)).max())
    steps = max(1, int(np.ceil(np.log2(max_width + 1))))
    # base/shift ride as [1] arrays.
    return (vals.astype(np.uint32), crs, bkt,
            np.array([base], np.int32), np.array([shift], np.int32),
            steps)


def default_index_mode(k: int) -> str:
    """Default hash-lookup strategy for the device D-SOFT: "twolevel",
    as darwin_tpu's.  All three modes give the same (start, end), so the
    default is only a speed choice."""
    del k
    return "twolevel"


def pad_reads(bank, read_ids, L: int | None = None):
    """[R, L] zero-padded query matrix + lengths from a SeqBank."""
    ids = np.asarray(list(read_ids), dtype=np.int64)
    lens = bank.lengths[ids]
    L = int(lens.max()) if L is None else L
    out = np.zeros((len(ids), L), dtype=np.uint8)
    for r, rid in enumerate(ids):
        s = bank.starts[rid]
        out[r, : lens[r]] = bank.flat[s: s + lens[r]]
    return out, lens.astype(np.int32)
