"""Tile span fetch: the CUDA kernel csrc/tile_fetch.cu, its plain
version fetch_tiles_torch, and the dispatch between them.

The port of darwin_tpu/ops/tile_fetch.py::fetch_tiles together with the
length masks the JAX engine applies after it.  Every tile is a
contiguous span of a flat uint8 bank: reverse-phase tiles read
[pos-len, pos) forward, forward-phase tiles read [pos, pos+len) back to
front (align.cpp:130 order).  The bank is the forward bytes only and
offsets are int64, so neither the TPU's reversed bank copy nor its
split (row, byte) addressing is needed.
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


def fetch_tiles(bank: torch.Tensor, start: torch.Tensor,
                length: torch.Tensor, backward: torch.Tensor, *,
                T: int, pad: int) -> torch.Tensor:
    """Same contract as fetch_tiles_torch."""
    if bank.device.type == "cpu":
        return fetch_tiles_torch(bank, start, length, backward, T=T,
                                 pad=pad)
    dev = _build.require_cuda(bank, "fetch_tiles")
    if bank.dim() != 1 or bank.shape[0] < 1:
        raise ValueError(f"fetch_tiles: bank must be a non-empty 1-D "
                         f"tensor, got {tuple(bank.shape)}")
    if T < 1 or not 0 <= pad <= 255:
        raise ValueError(f"fetch_tiles: T={T}, pad byte {pad}")
    if start.dim() != 1:
        raise ValueError(f"fetch_tiles: start must be [B], got "
                         f"{tuple(start.shape)}")
    B = start.shape[0]
    args = [_build.arg(bank, "bank", torch.uint8, (bank.shape[0],), dev),
            bank.shape[0],
            _build.arg(start, "start", torch.int64, (B,), dev),
            _build.arg(length, "length", torch.int32, (B,), dev),
            _build.arg(backward, "backward", torch.bool, (B,), dev)]
    out = torch.empty((B, T), dtype=torch.uint8, device=dev)
    if B:
        _build.launch("dtt_fetch_tiles", dev, *args, B, T, pad,
                      out.data_ptr())
        fetch_tiles.launches += 1
    return out


fetch_tiles.launches = 0
