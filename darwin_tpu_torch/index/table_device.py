"""The seed table built on the card: minimizer scan and stable hash sort.

Replaces the host build of darwin_tpu/index/seed_table.py's
SeedTable.build (the JAX package had no TPU kernel for it: the native
library's threaded scan and radix sort, then a NumPy filter and split),
for SeedTable.build(..., device=<a CUDA device>).  Two kernels of
csrc/seed_table.cu (the scan bound by its hashing's int32 operations,
the sort by its bytes; the source's head comment gives the design):

* minimizer_keys: the reference-genome w-window minimizers of a uint8
  sequence as two uint32 arrays (hash, pos), in scan order, positions
  below the sequence's length (dtnative.cpp dt_build_table's scan and
  SeedTable.build's filter);
* sort_keys: the keys stably sorted on the hash's 2k bits, so positions
  stay ascending within a hash (the reference's order of (hash << 32) |
  pos), 8 bits a pass.

Each takes its plain version (minimizer_keys_torch, sort_keys_torch: the
same scan, anchor, emit rule and digit passes in PyTorch) for a CPU
tensor and launches its kernel, or raises, for a CUDA one; each counts
its launches on .launches.  table_arrays uploads a sequence, runs both
on the card and downloads the table through pinned memory; its buffers
are sized from the scan's exact key count.
"""

from __future__ import annotations

import numpy as np
import torch

from darwin_tpu_torch import _build
from darwin_tpu_torch.coding import _TWOBIT_LUT

TILE = 4096  # positions a scan tile, keys a sort tile (csrc kTile)
DIGIT_BITS = 8  # a sort pass's digit
_U32 = torch.uint32
_CODES = torch.from_numpy(_TWOBIT_LUT.astype(np.int64))


def scan_range(n: int, k: int, w: int) -> tuple[int, int]:
    """The scanned positions [lo, hi) of n bases: the reference-genome
    convention, s_len = 1 + n // 16 words."""
    return w - 1, 16 * (1 + n // 16) - k - w


def _check_kw(k: int, w: int) -> None:
    if not (3 < k <= 15 and 1 <= w < k):
        raise ValueError(f"k={k}, w={w}: need 3 < k <= 15 and 1 <= w < k")


def _empty(device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty(0, dtype=_U32, device=device),
            torch.empty(0, dtype=_U32, device=device))


def _hash32(key: torch.Tensor, mask: int) -> torch.Tensor:
    """dtnative.cpp's hash32 on int64 keys below 2^2k (the uint32
    arithmetic's low bits, which the masks keep)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    return (key + (key << 31)) & mask


def minimizer_keys_torch(bases: torch.Tensor, k: int, w: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of minimizer_keys: (hash, pos) uint32 in scan order.

    m(p) is the least hash of the w seeds ending at p; a change is m(p)
    != m(p-1) (at lo, m(lo) != 0); p emits where (p - anchor) % w == 0
    for its last change at or before it, or before any change where p %
    w == 0 and p > 0; positions >= n are dropped."""
    _check_kw(k, w)
    n = bases.shape[0]
    lo, hi = scan_range(n, k, w)
    dev = bases.device
    if hi <= lo:
        return _empty(dev)
    codes = torch.zeros(hi + k, dtype=torch.int64, device=dev)
    m = min(n, hi + k)
    codes[:m] = _CODES.to(dev)[bases[:m].long()]
    seed = torch.zeros(hi, dtype=torch.int64, device=dev)
    for j in range(k):
        seed |= codes[j:j + hi] << (2 * j)
    h = _hash32(seed, (1 << (2 * k)) - 1)
    wmin = h.unfold(0, w, 1).min(dim=1).values  # ends at p = lo .. hi-1
    p = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    prev = torch.cat([wmin.new_zeros(1), wmin[:-1]])
    change = wmin != prev
    anchor = torch.cummax(torch.where(change, p, -1), dim=0).values
    emit = torch.where(anchor < 0, (p % w == 0) & (p > 0),
                       (p - anchor) % w == 0) & (p < n)
    return wmin[emit].to(_U32), p[emit].to(_U32)


def sort_keys_torch(hashes: torch.Tensor, pos: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of sort_keys: least-significant digit first, 8 bits
    a pass, each pass a stable counting sort (every digit's keys in the
    order they came)."""
    h = hashes.to(torch.int64)
    p = pos.to(torch.int64)
    for shift in range(0, 2 * k, DIGIT_BITS):
        digit = (h >> shift) & ((1 << DIGIT_BITS) - 1)
        order = torch.cat([torch.nonzero(digit == d).flatten()
                           for d in range(1 << DIGIT_BITS)])
        h, p = h[order], p[order]
    return h.to(_U32), p.to(_U32)


def minimizer_keys(bases: torch.Tensor, k: int, w: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference-genome w-window minimizers of bases (uint8 [n]) as
    (hash, pos) uint32 in scan order, positions below n: the kernels
    seed_count, seed_offsets and seed_emit, with one wait for the key
    count between them."""
    if bases.device.type == "cpu":
        return minimizer_keys_torch(bases, k, w)
    _check_kw(k, w)
    dev = _build.require_cuda(bases, "minimizer_keys")
    n = bases.shape[0]
    lo, hi = scan_range(n, k, w)
    if n >= 2**32 - 16:
        raise ValueError(f"minimizer_keys: {n} bases; positions are uint32")
    if hi <= lo:
        return _empty(dev)
    b = _build.arg(bases, "bases", torch.uint8, (n,), dev)
    tiles = -(-(hi - lo) // TILE)
    meta = torch.empty(5 * tiles + 1, dtype=torch.int64, device=dev)
    _build.launch("dtt_seed_count", dev, b, n, k, w, meta)
    total = int(meta[-1])
    hashes = torch.empty(total, dtype=_U32, device=dev)
    pos = torch.empty(total, dtype=_U32, device=dev)
    if total:
        _build.launch("dtt_seed_emit", dev, b, n, k, w, meta, hashes, pos)
    minimizer_keys.launches += 1
    return hashes, pos


def sort_keys(hashes: torch.Tensor, pos: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hash, pos) sorted stably on the hash's 2k bits.  On the card the
    inputs are the first pair of the passes' ping-pong: after the call
    they hold an intermediate pass or the result, which is returned."""
    if hashes.device.type == "cpu":
        return sort_keys_torch(hashes, pos, k)
    dev = _build.require_cuda(hashes, "sort_keys")
    n = hashes.shape[0]
    h = _build.arg(hashes, "hashes", _U32, (n,), dev)
    p = _build.arg(pos, "pos", _U32, (n,), dev)
    if not n:
        return h, p
    tiles = -(-n // TILE)
    h2, p2 = torch.empty_like(h), torch.empty_like(p)
    scratch = torch.empty(256 * (tiles + 1), dtype=_U32, device=dev)
    _build.launch("dtt_radix_sort", dev, h, p, h2, p2, n, 2 * k, scratch)
    sort_keys.launches += 1
    passes = -(-2 * k // DIGIT_BITS)
    return (h2, p2) if passes % 2 else (h, p)


minimizer_keys.launches = 0
sort_keys.launches = 0


def table_arrays(seq: np.ndarray, k: int, w: int, device
                 ) -> tuple[np.ndarray, np.ndarray]:
    """SeedTable's hashes and pos (uint32 NumPy arrays) of seq (uint8),
    built on device, a CUDA device, and downloaded through pinned
    memory; the device buffers are released on return."""
    bases = torch.from_numpy(seq if seq.flags.writeable else seq.copy())
    h, p = sort_keys(*minimizer_keys(bases.to(device), k, w), k)
    out = [torch.empty(t.shape, dtype=_U32, pin_memory=True) for t in (h, p)]
    for dst, src in zip(out, (h, p)):
        dst.copy_(src, non_blocking=True)
    torch.cuda.current_stream(h.device).synchronize()
    return out[0].numpy(), out[1].numpy()
