"""darwin_tpu_torch.entry, the port of __graft_entry__.py: entry()'s
step runs on its example batch and equals __graft_entry__'s (backend
lax), and dryrun_multichip's parity checks pass over a mesh of two CPU
entries at the full-size shape."""

import sys
from pathlib import Path

import jax
import numpy as np

from darwin_tpu_torch import entry as port_entry
from tests._torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import __graft_entry__  # noqa: E402


def test_example_batch_equals_graft_entry():
    for got, want in zip(port_entry._example_batch(48, 32, seed=5),
                         __graft_entry__._example_batch(48, 32, seed=5)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_entry_step_equals_graft_entry():
    fn, args = port_entry.entry("cpu")
    got = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    want = jax.device_get(jax.jit(jfn)(*jargs))
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), b)
    ops = np.asarray(want[0]).T if want[0].shape[0] != 64 else want[0]
    np.testing.assert_array_equal(got[0].numpy() & 3, np.asarray(ops) & 3)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dryrun_multichip_on_two_cpu_entries(capsys):
    port_entry.dryrun_multichip(2, devices=["cpu"] * 2)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: 2 devices" in out and "EXACT" in out
