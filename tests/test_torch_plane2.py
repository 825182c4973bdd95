"""The plane-2 emitter against the JAX probe's own kernel.

tools/plane2_probe.py is imported and run in its CPU mode (B = 256,
V = 2, interpret mode; T = 24), with its `bench` swapped for one that
runs the handed function once and keeps the result.  The port's lab
(darwin_tpu_torch.lab.plane2_probe, --device cpu) must print the same
sinks from the same inputs, and the probe kernel's two planes and stats,
captured from its pallas_call, must equal the port's plane-2 output
(plain version: align_tiles_torch, pack_dir_words6, plane2_words)
element by element.  The gather probe's sinks are compared the same
way.  Integers throughout: the tolerance is 0.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from darwin_tpu_torch.lab import plane2_probe as lab
from darwin_tpu_torch.lab import SCORING, related_batches
from darwin_tpu_torch.ops import plane2
from tests._torch_threads import one_torch_thread  # noqa: F401

TOOL = Path(__file__).resolve().parent.parent / "tools" / "plane2_probe.py"
B, V, T = 256, 2, 24


@pytest.fixture
def probe():
    """The JAX probe module in its CPU mode, with bench recording
    (function, args, sink) instead of timing."""
    spec = importlib.util.spec_from_file_location("jax_plane2_probe", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.V, mod.INTERPRET = B, V, True
    calls = []

    def bench(fn, *args, reps=3):
        sink = jax.device_get(fn(*args))
        calls.append((fn, args, int(sink)))
        return 1.0, sink  # any nonzero time: the probe divides by it

    mod.bench = bench
    return mod, calls


def test_emit_sinks_match_probe(probe):
    mod, calls = probe
    mod.probe_emit(T)
    assert len(calls) == 2  # packed6 base, packed6+plane2
    refs, queries = related_batches(V, B, T)
    np.testing.assert_array_equal(np.asarray(calls[0][1][0]), refs)
    np.testing.assert_array_equal(np.asarray(calls[0][1][1]), queries)
    got = lab.probe_emit(T, torch.device("cpu"), B, V, reps=1)
    assert got["packed6 base"][1] == calls[0][2]
    assert got["packed6+plane2"][1] == calls[1][2]


def test_emit_runs_at_a_split_tile_size(capsys):
    """The emit probe at T = 1025, past the one-warp DP (on the card the
    split kernels, here the plain version): its sinks are the tool's sink
    definitions on the plain plane-2 output of the same inputs."""
    Ts, Bs = 1025, 2
    got = lab.probe_emit(Ts, torch.device("cpu"), Bs, 1, reps=1)
    refs, queries = (torch.from_numpy(x[0]) for x in
                     related_batches(1, Bs, Ts))
    lens = torch.full((Bs,), Ts, dtype=torch.int32)
    out = plane2.plane2_torch(refs, queries, lens, lens, **SCORING)
    assert got["packed6 base"][1] == lab.sum32(lab.base_sink(out))
    assert got["packed6+plane2"][1] == lab.sum32(lab.plane2_sink(out))
    assert "T=1025" in capsys.readouterr().out


def test_plane2_planes_match_probe_kernel(probe, monkeypatch):
    """Both planes and the stats of the probe's kernel2, step by step,
    against the port: the second plane's definition is confirmed on the
    probe's own kernel."""
    mod, calls = probe
    outs = []
    real = pallas.pallas_call

    def spy(kernel, **kw):
        f = real(kernel, **kw)

        def run(*args):
            res = f(*args)
            outs.append(res)
            return res
        return run

    monkeypatch.setattr(pallas, "pallas_call", spy)
    with jax.disable_jit():
        mod.probe_emit(T)
    planes = [o for o in outs if len(o) == 3]  # kernel2: d1, d2, stats
    assert len(planes) == V
    refs, queries = related_batches(V, B, T)
    lens = torch.full((B,), T, dtype=torch.int32)
    for v, (d1, d2, st) in enumerate(planes):
        got = plane2.plane2(torch.from_numpy(refs[v]),
                            torch.from_numpy(queries[v]), lens, lens,
                            **SCORING)
        np.testing.assert_array_equal(np.asarray(d1)[:, :, :T + 1],
                                      got["dir_words"].numpy())
        np.testing.assert_array_equal(np.asarray(d2)[:, :, :T + 1],
                                      got["dir2_words"].numpy())
        assert got["dir2_words"].any()
        st = np.asarray(st)
        for c, k in enumerate(("max_score", "max_i", "max_j", "pos_score")):
            np.testing.assert_array_equal(st[:, c], got[k].numpy(), err_msg=k)


def test_gather_sinks_match_probe(probe):
    mod, calls = probe
    mod.probe_gather(T)
    assert len(calls) == len(lab.GATHER_MODES)
    flat1, flat2 = lab.gather_inputs(B, T)
    np.testing.assert_array_equal(np.asarray(calls[0][1][0]), flat1)
    np.testing.assert_array_equal(np.asarray(calls[0][1][1]), flat2)
    got = lab.probe_gather(T, torch.device("cpu"), B, V, reps=1)
    for mode, (_, _, want) in zip(lab.GATHER_MODES, calls):
        assert got[mode][2] == want, mode
