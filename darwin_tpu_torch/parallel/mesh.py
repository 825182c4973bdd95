"""Multi-device scaling over a mesh of torch devices in one process.

The port of darwin_tpu/parallel/mesh.py.  A Mesh is a list of
torch.devices with one axis, "data", as a JAX Mesh is a list of local
devices under shard_map; the sharded functions run one body a mesh
entry, each on its entry's device (parallel/collectives.on_each), and
exchange data through parallel/collectives.py:

* data parallelism over tiles: ShardedTileAligner splits the tile batch
  in contiguous blocks over the mesh, each entry running the packed6 DP
  and walker (engine/aligner.tile_step) on its block;
* the overlap merge: merge_overlap_records gathers every entry's numeric
  records and sorts them, the reference's `sort | uniq` merge.

make_mesh takes the first n visible CUDA devices and raises when fewer
are visible (jax.make_mesh's counterpart there quietly builds a smaller
mesh); an explicit devices= list, such as ["cuda:0"] * 4 or ["cpu"] * 8,
builds a mesh of any size on the devices there are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from darwin_tpu_torch.engine.aligner import TileResult, tile_step
from darwin_tpu_torch.ops.dp import check_tile_size
from darwin_tpu_torch.parallel.collectives import all_gather, on_each


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple
    axis_names: tuple = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n: int | None = None, *, devices=None) -> Mesh:
    """A mesh of the first n visible CUDA devices (all of them when n is
    None), or of the devices listed; raises RuntimeError when fewer than
    n CUDA devices are visible."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs or (n is not None and n != len(devs)):
            raise ValueError(f"make_mesh: n={n} with {len(devs)} devices "
                             f"listed")
        return Mesh(devs)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else n
    if not 1 <= n <= have:
        raise RuntimeError(f"make_mesh: a mesh of {n} CUDA devices asked "
                           f"for, {have} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def sharded_tile_step(mesh: Mesh, *, early_terminate: int, match: int,
                      mismatch: int, gap_open: int, gap_extend: int):
    """The batch-sharded DP + traceback step: fn(ref_tiles [B, T],
    query_tiles, rlens, qlens, firsts) with B a multiple of the mesh size,
    each contiguous block of B / size tiles run by tile_step on its mesh
    entry; returns tile_step's six outputs on the mesh's first device."""
    kw = dict(early_terminate=early_terminate, match=match,
              mismatch=mismatch, gap_open=gap_open, gap_extend=gap_extend)

    def step(ref, query, rlen, qlen, first):
        B = ref.shape[0]
        if B % mesh.size:
            raise ValueError(f"sharded_tile_step: batch {B} is no multiple "
                             f"of the mesh size {mesh.size}")
        b = B // mesh.size
        parts = [tuple(x[i * b:(i + 1) * b].to(d)
                       for x in (ref, query, rlen, qlen, first))
                 for i, d in enumerate(mesh.devices)]
        outs = on_each(mesh.devices, lambda i: tile_step(*parts[i], **kw))
        return tuple(torch.cat([x.to(mesh.devices[0]) for x in col])
                     for col in zip(*outs))

    return step


class ShardedTileAligner:
    """The host-stepped engine's aligner with the tile batch sharded over
    a mesh (darwin_tpu's ShardedTileAligner): a drop-in for
    TorchTileAligner.  The batch is padded to a multiple of the mesh
    size (ref pad 1, query pad 2, empty lengths, as darwin_tpu pads)."""

    def __init__(self, mesh: Mesh, *, tile_size: int, early_terminate: int,
                 match: int, mismatch: int, gap_open: int, gap_extend: int):
        if any(d.type == "cuda" for d in mesh.devices):
            check_tile_size(tile_size, "ShardedTileAligner")
        self.mesh = mesh
        self.n_dev = mesh.size
        self.device = mesh.devices[0]  # run_host seeds here
        self.calls = 0  # batches aligned (host engine iterations)
        self._step = sharded_tile_step(
            mesh, early_terminate=early_terminate, match=match,
            mismatch=mismatch, gap_open=gap_open, gap_extend=gap_extend)

    def _pad(self, B: int) -> int:
        return -(-B // self.n_dev) * self.n_dev

    def __call__(self, ref_tiles, query_tiles, ref_lens, query_lens,
                 firsts) -> TileResult:
        B = ref_tiles.shape[0]
        BP = self._pad(B)
        if BP != B:
            pad = ((0, BP - B), (0, 0))
            ref_tiles = np.pad(ref_tiles, pad, constant_values=1)
            query_tiles = np.pad(query_tiles, pad, constant_values=2)
            ref_lens = np.pad(ref_lens, (0, BP - B))
            query_lens = np.pad(query_lens, (0, BP - B))
            firsts = np.pad(firsts, (0, BP - B))
        out = self._step(*(torch.from_numpy(np.ascontiguousarray(x, dtype=t))
                           for x, t in ((ref_tiles, np.uint8),
                                        (query_tiles, np.uint8),
                                        (ref_lens, np.int32),
                                        (query_lens, np.int32),
                                        (firsts, bool))))
        self.calls += 1
        ops, *stats = (x[:B].cpu().numpy() for x in out)
        return TileResult(ops, *stats)


def merge_overlap_records(mesh: Mesh, local_records: np.ndarray
                          ) -> np.ndarray:
    """Deterministic merge of numeric overlap records: [N, 8] int32 rows
    (ref_id, query_id, ab, ae, bb, be, score, comp), N a multiple of the
    mesh size, in one contiguous block a mesh entry, are gathered over
    the mesh, rows with ref_id < 0 (padding) dropped, and the rest sorted
    lexicographically and made unique (the reference's `sort | uniq`,
    README:25)."""
    n = local_records.shape[0] // mesh.size
    blocks = [torch.from_numpy(np.ascontiguousarray(
        local_records[i * n:(i + 1) * n])).to(d)
        for i, d in enumerate(mesh.devices)]
    rows = all_gather(blocks)[0].cpu().numpy()
    rows = rows[rows[:, 0] >= 0]
    rows = rows[np.lexsort(rows.T[::-1])]
    keep = np.ones(len(rows), dtype=bool)
    keep[1:] = (rows[1:] != rows[:-1]).any(axis=1)
    return rows[keep]
