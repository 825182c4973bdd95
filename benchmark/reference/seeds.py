"""Plain D-SOFT: minimizers, the seed index and candidate filtration.

Written from Darwin's seed_pos_table.cpp and ntcoding.cpp (the CPU build's
semantics) in PyTorch and NumPy, with no code of the program under test:

* Bases code A=0, C=1, G=2, T=3, every other byte 0; a k-mer's code has
  base p+t at bits 2t (16 bases a little-endian word).
* The scan covers positions w-1 <= p < 16*s_len - k - w over a zero
  padded tail, with s_len = 1 + len//16 words for the reference and
  ceil(len/16) for a query (seed_pos_table.cpp:60, 108).
* A window minimum (Thomas Wang's hash masked to 2k bits) is emitted where
  it changes, or where the last emission is w positions old.
* The index sorts (hash, position) and drops positions past the padded
  reference; a hash occurring more than multiple * (1 + (len >> 2k))
  times is skipped; the first num_seeds + 1 minimizers that pass are
  used; a bin of the diagonal counts k for a fresh seed and the offset
  step (at most k) for an overlapping one, and emits one candidate when
  it reaches the threshold; at most max_candidates are kept.

Only the hashes that the sampled queries carry are kept in the index: a
hash's occurrence count is the same in that subset as in the whole table.
"""

from __future__ import annotations

import numpy as np
import torch

I64 = torch.int64


def _twobit_lut(device) -> torch.Tensor:
    lut = torch.zeros(256, dtype=I64, device=device)
    for c, v in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
        lut[c] = v
    return lut


def wang_hash(key: torch.Tensor, k: int) -> torch.Tensor:
    """Thomas Wang's 32-bit hash, masked to 2k bits after every step,
    on int64 (the masked low bits equal the uint32 arithmetic's)."""
    m = (1 << (2 * k)) - 1
    key = (~key + (key << 21)) & m
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & m
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & m
    key = key ^ (key >> 28)
    return (key + (key << 31)) & m


def minimizers(seq: torch.Tensor, k: int, w: int, *, reference: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions, hashes) of a uint8 sequence's minimizers, in scan
    order, both int64 on the sequence's device."""
    e = torch.empty(0, dtype=I64, device=seq.device)
    parts = list(minimizer_chunks(seq, k, w, reference=reference))
    return (torch.cat([e] + [p for p, _ in parts]),
            torch.cat([e] + [h for _, h in parts]))


def minimizer_chunks(seq: torch.Tensor, k: int, w: int, *, reference: bool,
                     chunk: int = 1 << 26):
    """minimizers(seq, k, w) a chunk of window positions at a time:
    yields (positions, hashes) whose concatenation is the whole scan's,
    each chunk's arrays a few times chunk int64 in size (a 3 Gb
    reference in one piece would need some 30 arrays of 24 GB).  A
    window minimum's run (its value and anchor) carries from one chunk
    into the next."""
    n = seq.numel()
    s_len = 1 + n // 16 if reference else (n + 15) // 16
    hi, lo = 16 * s_len - k - w, w - 1
    dev = seq.device
    lut = _twobit_lut(dev)
    last_m = torch.zeros(1, dtype=I64, device=dev)
    last_anchor = torch.zeros(1, dtype=I64, device=dev)
    # Window j ends at position lo + j and takes k-mers j .. j + w - 1,
    # which read bases j .. j + w + k - 2 (past n: code 0).
    for a in range(0, max(0, hi - lo), chunk):
        b = min(a + chunk, hi - lo)
        span = b - a + w - 1
        codes = torch.zeros(span + k - 1, dtype=I64, device=dev)
        got = seq[a:min(n, a + span + k - 1)]
        codes[:got.numel()] = lut[got.long()]
        kmer = torch.zeros(span, dtype=I64, device=dev)
        for t in range(k):
            kmer |= codes[t:t + span] << (2 * t)
        del codes
        h = wang_hash(kmer, k)
        del kmer
        m = h[:b - a].clone()
        for s in range(1, w):
            torch.minimum(m, h[s:s + b - a], out=m)
        del h
        p = torch.arange(lo + a, lo + b, dtype=I64, device=dev)
        change = m != torch.cat([last_m, m[:-1]])
        run_id = torch.cumsum(change, 0)
        anchors = torch.zeros(int(run_id[-1]) + 1, dtype=I64, device=dev)
        anchors[:1] = last_anchor
        anchors[run_id[change]] = p[change]
        offset = p - anchors[run_id]
        emit = change | ((offset % w == 0) & (offset > 0))
        last_m, last_anchor = m[-1:], anchors[-1:]
        yield p[emit], m[emit]


class Layout:
    """Pieces concatenated, each padded with 'N' to a multiple of
    bin_size (darwin.cpp:530-546), with the bin maps that decode a hit."""

    def __init__(self, pieces: list[np.ndarray], bin_size: int):
        self.bin_size = bin_size
        self.lengths = np.array([len(p) for p in pieces], dtype=np.int64)
        nbins = -(-self.lengths // bin_size)
        self.start_bin = np.concatenate([[0], np.cumsum(nbins)[:-1]]
                                        ).astype(np.int64)
        self.bin_to_piece = np.repeat(np.arange(len(pieces)), nbins)
        self.size = int(nbins.sum()) * bin_size

    def concat(self, pieces: list[np.ndarray], device) -> torch.Tensor:
        out = torch.full((self.size,), ord("N"), dtype=torch.uint8,
                         device=device)
        for s, p in zip(self.start_bin * self.bin_size, pieces):
            out[s:s + len(p)] = torch.from_numpy(p).to(device)
        return out

    def decode(self, hits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        piece = self.bin_to_piece[hits // self.bin_size]
        local = hits - self.start_bin[piece] * self.bin_size
        return piece, np.minimum(local, self.lengths[piece])


class SeedIndex:
    """The (hash, position)-sorted minimizers of the padded reference
    whose hash is in `wanted`, on the host."""

    def __init__(self, concat: torch.Tensor, wanted: np.ndarray, p: dict):
        k, w = p["seed_size"], p["window_size"]
        self.k, self.bin_size = k, p["bin_size"]
        self.size = concat.numel()
        self.max_occ = p["seed_occurence_multiple"] * (
            1 + (self.size >> (2 * k)))
        want = torch.from_numpy(np.unique(wanted)).to(concat.device)
        keys = [torch.zeros(0, dtype=I64, device=concat.device)]
        for pos, h in minimizer_chunks(concat, k, w, reference=True):
            keep = (pos < self.size) & torch.isin(h, want)
            keys.append((h[keep] << 32) | pos[keep])
        key = torch.sort(torch.cat(keys)).values.cpu().numpy()
        self.hashes = key >> 32
        self.pos = key & 0xFFFFFFFF


def dsoft(index: SeedIndex, offs: np.ndarray, hashes: np.ndarray,
          p: dict) -> tuple[np.ndarray, np.ndarray]:
    """(hits, offsets) of one query strand's candidates, in emission
    order (seed_pos_table.cpp:100-167)."""
    empty = np.empty(0, dtype=np.int64)
    start = np.searchsorted(index.hashes, hashes, side="left")
    count = np.searchsorted(index.hashes, hashes, side="right") - start
    passing = count <= index.max_occ
    used = np.flatnonzero(passing & (np.cumsum(passing)
                                     <= p["num_seeds"] + 1))
    n = count[used]
    if n.sum() == 0:
        return empty, empty
    # Tuples in scan order: minimizer order, then position order.
    which = np.repeat(used, n)
    first = np.repeat(np.cumsum(n) - n, n)
    hit = index.pos[np.repeat(start[used], n) + np.arange(n.sum()) - first]
    off = offs[which]
    ok = hit >= off
    hit, off, order = hit[ok], off[ok], np.flatnonzero(ok)
    if len(hit) == 0:
        return empty, empty
    b = (hit - off) // index.bin_size
    s = np.argsort(b, kind="stable")
    b, hit, off, order = b[s], hit[s], off[s], order[s]
    fresh = np.ones(len(b), dtype=bool)
    fresh[1:] = b[1:] != b[:-1]
    step = np.minimum(np.diff(off, prepend=off[0]), index.k)
    inc = np.where(fresh, index.k, step)
    total = np.cumsum(inc)
    count_in_bin = total - np.maximum.accumulate(
        np.where(fresh, total - inc, 0))
    reached = count_in_bin >= p["threshold"]
    before = np.zeros(len(b), dtype=bool)
    before[1:] = reached[:-1] & ~fresh[1:]
    emit = reached & ~before
    e = np.argsort(order[emit], kind="stable")[:p["max_candidates"]]
    return hit[emit][e], off[emit][e]
