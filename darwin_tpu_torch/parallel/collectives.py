"""The collectives of a mesh, as tensor moves between its devices.

darwin_tpu's sharded programs run one body a device under shard_map and
exchange data with psum, all_gather, all_to_all and pmax.  Here a mesh
is a list of torch devices in one process (parallel/mesh.py): a
collective takes one tensor a mesh entry, each on its entry's device,
and returns one result a mesh entry, copied to that entry's device.
on_each runs a function once a mesh entry, in turn, each with its
entry's device current.
"""

from __future__ import annotations

import functools

import torch


def _spread(total: torch.Tensor, like: list) -> list:
    """total copied to the device of each tensor of like."""
    return [total.to(x.device) for x in like]


def psum(xs: list) -> list:
    """The sum of the per-entry tensors, on every entry (jax.lax.psum)."""
    return _spread(functools.reduce(
        lambda a, b: a + b.to(a.device), xs[1:], xs[0].clone()), xs)


def por(xs: list) -> list:
    """The OR of the per-entry bool tensors, on every entry (the pmax of
    0/1 flags)."""
    return _spread(functools.reduce(
        lambda a, b: a | b.to(a.device), xs[1:], xs[0].clone()), xs)


def all_gather(xs: list) -> list:
    """The per-entry tensors concatenated along dim 0 in mesh order, on
    every entry (jax.lax.all_gather(..., tiled=True))."""
    return _spread(torch.cat([x.to(xs[0].device) for x in xs]), xs)


def all_to_all(bufs: list) -> list:
    """Entry s sends bufs[s][d] ([P, ...]: one row a destination) to
    entry d, which receives the rows of every source concatenated in
    mesh order (jax.lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=False), flattened)."""
    return [torch.cat([b[d].to(bufs[d].device) for b in bufs])
            for d in range(len(bufs))]


def on_each(devices, fn) -> list:
    """[fn(i) for each mesh entry i], in turn in the calling thread, each
    call with devices[i] as the current CUDA device where it is one.
    The reference runs one pthread and one CUDA stream a read range
    (darwin.cpp:619-632); here one thread an entry was four to five
    times slower on one H100 (tools/torch_mesh_engine.py), and six
    times slower over CPU entries: the engines' loops are host-bound
    and the threads contend for the GIL."""
    devices = [torch.device(d) for d in devices]
    out = []
    for i, d in enumerate(devices):
        if d.type == "cuda":
            with torch.cuda.device(d):
                out.append(fn(i))
        else:
            out.append(fn(i))
    return out
