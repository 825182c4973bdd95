"""Tile span fetch: the CUDA kernel csrc/tile_fetch.cu, its plain
versions fetch_tiles_torch and fetch_tile_pair_torch, and the dispatch
between them.

The port of darwin_tpu/ops/tile_fetch.py::fetch_tiles together with the
length masks the JAX engine applies after it.  Every tile is a
contiguous span of a flat uint8 bank: reverse-phase tiles read
[pos-len, pos) forward, forward-phase tiles read [pos, pos+len) back to
front (align.cpp:130 order).  The bank is the forward bytes only and
offsets are int64, so neither the TPU's reversed bank copy nor its
split (row, byte) addressing is needed.  fetch_tile_pair fetches an
iteration's ref and query tiles in one launch of the same kernel.
"""

from __future__ import annotations

import torch

from darwin_tpu_torch import _build


def fetch_tiles_torch(bank: torch.Tensor, start: torch.Tensor,
                      length: torch.Tensor, backward: torch.Tensor, *,
                      T: int, pad: int) -> torch.Tensor:
    """out[b, k] = bank[start[b] + k] (or bank[start[b] + length[b] - 1
    - k] where backward[b]) for k < length[b], else pad.  Offsets are
    clipped into the bank.

    bank: [N] uint8, N >= 1; start: [B] int64; length: [B] int32;
    backward: [B] bool.  Returns [B, T] uint8."""
    k = torch.arange(T, dtype=torch.int64, device=bank.device)[None, :]
    s = start.to(torch.int64)[:, None]
    L = length.to(torch.int64)[:, None]
    idx = torch.where(backward[:, None], s + L - 1 - k, s + k)
    v = bank[idx.clamp(0, bank.shape[0] - 1)]
    return torch.where(k < L, v, pad).to(torch.uint8)


def fetch_tile_pair_torch(gbank: torch.Tensor, qbank: torch.Tensor,
                          g_start: torch.Tensor, q_start: torch.Tensor,
                          rl: torch.Tensor, ql: torch.Tensor,
                          backward: torch.Tensor, *, T: int, pad_ref: int,
                          pad_query: int):
    """(ref tiles, query tiles): fetch_tiles_torch on each bank, with one
    backward flag a slot for both."""
    return (fetch_tiles_torch(gbank, g_start, rl, backward, T=T,
                              pad=pad_ref),
            fetch_tiles_torch(qbank, q_start, ql, backward, T=T,
                              pad=pad_query))


def _span_set(bank, start, length, pad, B, T, dev, what):
    """One span set's C arguments, checked, and its output tensor."""
    if bank.dim() != 1 or bank.shape[0] < 1:
        raise ValueError(f"{what}: bank must be a non-empty 1-D tensor, "
                         f"got {tuple(bank.shape)}")
    if not 0 <= pad <= 255:
        raise ValueError(f"{what}: pad byte {pad}")
    out = torch.empty((B, T), dtype=torch.uint8, device=dev)
    # The kernel's aligned 16-byte loads may read up to the end of the
    # bank's storage (device_banks pads it to a multiple of 16 bytes).
    n_read = bank.untyped_storage().nbytes() - bank.storage_offset()
    return [_build.arg(bank, "bank", torch.uint8, (bank.shape[0],), dev),
            bank.shape[0], n_read,
            _build.arg(start, "start", torch.int64, (B,), dev),
            _build.arg(length, "length", torch.int32, (B,), dev), pad,
            out], out


def _launch(sets: list, backward: torch.Tensor, T: int, what: str) -> list:
    """Launch csrc/tile_fetch.cu on one or two (bank, start, length, pad)
    sets of CUDA tensors; returns their [B, T] outputs."""
    dev = _build.require_cuda(sets[0][0], what)
    if T < 1:
        raise ValueError(f"{what}: T={T}")
    if sets[0][1].dim() != 1:
        raise ValueError(f"{what}: start must be [B], got "
                         f"{tuple(sets[0][1].shape)}")
    B = sets[0][1].shape[0]
    if B * -(-T // 16) >= 2 ** 31:  # the kernel's int thread index
        raise ValueError(f"{what}: B={B}, T={T} is too large")
    args, outs = [], []
    for bank, start, length, pad in sets:
        a, out = _span_set(bank, start, length, pad, B, T, dev, what)
        args += a
        outs.append(out)
    if len(sets) == 1:
        args += [None, 0, 0, None, None, 0, None]
    back = _build.arg(backward, "backward", torch.bool, (B,), dev)
    if B:
        _build.launch("dtt_fetch_tiles", dev, len(sets), *args, back, B, T)
        fetch_tiles.launches += 1
    return outs


def fetch_tiles(bank: torch.Tensor, start: torch.Tensor,
                length: torch.Tensor, backward: torch.Tensor, *,
                T: int, pad: int) -> torch.Tensor:
    """Same contract as fetch_tiles_torch."""
    if bank.device.type == "cpu":
        return fetch_tiles_torch(bank, start, length, backward, T=T,
                                 pad=pad)
    return _launch([(bank, start, length, pad)], backward, T,
                   "fetch_tiles")[0]


def fetch_tile_pair(gbank: torch.Tensor, qbank: torch.Tensor,
                    g_start: torch.Tensor, q_start: torch.Tensor,
                    rl: torch.Tensor, ql: torch.Tensor,
                    backward: torch.Tensor, *, T: int, pad_ref: int,
                    pad_query: int):
    """Same contract as fetch_tile_pair_torch; one launch for both sets,
    counted on fetch_tiles.launches."""
    if gbank.device.type == "cpu":
        return fetch_tile_pair_torch(gbank, qbank, g_start, q_start, rl, ql,
                                     backward, T=T, pad_ref=pad_ref,
                                     pad_query=pad_query)
    ref_t, query_t = _launch([(gbank, g_start, rl, pad_ref),
                              (qbank, q_start, ql, pad_query)], backward, T,
                             "fetch_tile_pair")
    return ref_t, query_t


# Launches of csrc/tile_fetch.cu, by fetch_tiles and fetch_tile_pair.
fetch_tiles.launches = 0
