"""The scan probe against the JAX probe's own kernels.

tools/scanshift_probe.py is imported and run in its CPU mode (B = 256,
V = 2, interpret mode; T = 24), with its `bench` swapped for one that
runs the handed function once and keeps the result.  The port's lab
(darwin_tpu_torch.lab.scanshift_probe, --device cpu) must compute the
same sink from the same inputs for both lowerings, and the probe's
Pallas kernels (concat-shift and roll+mask) must equal
scanshift_torch (16 chained torch.cummax scans) element by element.
Integers throughout: the tolerance is 0.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from darwin_tpu_torch.lab import scanshift_probe as lab
from darwin_tpu_torch.ops import scanshift
from tests._torch_threads import one_torch_thread  # noqa: F401

TOOL = Path(__file__).resolve().parent.parent / "tools" / "scanshift_probe.py"
B, V, T = 256, 2, 24


@pytest.fixture(scope="module")
def probe_calls():
    """Run the JAX probe once in CPU mode; returns its bench calls as
    (mode's Pallas function, input, sink)."""
    spec = importlib.util.spec_from_file_location("jax_scanshift_probe",
                                                  TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.V, mod.INTERPRET = B, V, True
    calls = []

    def bench(fn, *args, reps=3):
        sink = jax.device_get(fn(*args))
        cells = dict(zip(fn.__code__.co_freevars,
                         (c.cell_contents for c in fn.__closure__)))
        calls.append((cells["one"], args[0], int(sink)))
        return 1.0, sink  # any nonzero time

    mod.bench = bench
    argv = sys.argv
    sys.argv = ["scanshift_probe.py", str(T)]
    try:
        assert mod.main() == 0
    finally:
        sys.argv = argv
    return calls


def test_inputs_and_sinks_match_probe(probe_calls):
    assert len(probe_calls) == 2  # concat, roll
    x, _ = lab.probe_inputs(V, B, T)
    for _, xs, _ in probe_calls:
        np.testing.assert_array_equal(np.asarray(xs), x)
    got = lab.run(T, torch.device("cpu"), B, V, reps=1)
    # Both TPU lowerings and both GPU lowerings give one sink.
    assert {s for _, _, s in probe_calls} == {got["shfl"][1]} \
        == {got["smem"][1]}


@pytest.mark.parametrize("mode", [0, 1], ids=["concat", "roll"])
def test_probe_kernels_match_cummax(probe_calls, mode):
    one, xs, _ = probe_calls[mode]
    x0 = np.array(xs[0])
    want = scanshift.scanshift_torch(torch.from_numpy(x0)).numpy()
    np.testing.assert_array_equal(np.asarray(one(xs[0])), want)
    for fn in (scanshift.scanshift_shfl, scanshift.scanshift_smem):
        np.testing.assert_array_equal(fn(torch.from_numpy(x0)).numpy(), want)


def test_scanshift_torch_is_sixteen_cummax_scans():
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -9, 9, size=(5, 7), dtype=np.int32))
    u = x.numpy().astype(np.int64)
    for s in range(scanshift.STEPS):
        u = np.maximum.accumulate(u + s, axis=1)
    np.testing.assert_array_equal(scanshift.scanshift_torch(x).numpy(), u)


@pytest.mark.parametrize("lowering", ["shfl", "smem"])
@pytest.mark.parametrize("C", chip_smoke.SCAN_WIDTHS)
def test_lowerings_at_the_kernel_width_edges(C, lowering):
    """Both lowerings at the widths where the kernel's columns a lane
    change (one side and the other of 1, 2, 12 and 32), at B = 37 (no
    multiple of its 8 rows a block), against numpy's
    maximum.accumulate."""
    x = chip_smoke.scan_edge_input(C, torch.device("cpu"))
    assert x.shape == (chip_smoke.SCAN_EDGE_B, C) and x.shape[0] % 8
    u = x.numpy().astype(np.int64)
    for s in range(scanshift.STEPS):
        u = np.maximum.accumulate(u + s, axis=1)
    fn = {"shfl": scanshift.scanshift_shfl,
          "smem": scanshift.scanshift_smem}[lowering]
    np.testing.assert_array_equal(fn(x).numpy(), u)
