"""The device engine's slot loop with its bookkeeping in two kernels
(ops/slot_loop.py, csrc/slot_loop.cu), on the CPU, where the kernels'
plain versions run:

* DeviceGactEngine._loop_fused equals _loop_torch (the PyTorch loop,
  the CPU's path): the records in order, the record count, iterations,
  active slot-iterations, calls done and the exported state, over every
  tb_format, same_file, compute_score, N below and above the slot count,
  and a drain that stops the first tier, the second resumed from its
  exported state (chip_smoke.slot_loop_workload: anchors at position 0,
  at a read's and a piece's end, calls that fail the first tile's
  threshold);
* on a CPU device _loop takes the PyTorch loop and counts
  engine_fused_iters 0, launching no kernel; the fused loop counts its
  iterations there;
* the [N+1, 16] state matrix round-trips through LoopOut.state in
  CSTATE_COLS order;
* _build._SIGNATURES holds both C entries, with the argument count the
  wrappers pass (meta tensors, _build.launch recorded).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from darwin_tpu_torch import _build
from darwin_tpu_torch.engine import device_batch as tdb
from darwin_tpu_torch.ops import slot_loop
from tests._torch_threads import one_torch_thread  # noqa: F401

SCORING = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)


def _engine(genome, bank, *, B, device="cpu", **kw):
    return tdb.DeviceGactEngine(
        genome, bank, tile_size=chip_smoke.SLOT_LOOP_T,
        early_terminate=chip_smoke.SLOT_LOOP_ET,
        first_tile_score_threshold=chip_smoke.SLOT_LOOP_THRESHOLD,
        batch_size=B, device=device, **{"same_file": False, **SCORING, **kw})


def _same(a: tdb.LoopOut, b: tdb.LoopOut):
    assert (a.nrec, a.iters, a.act_sum, a.calls_done) == \
        (b.nrec, b.iters, b.act_sum, b.calls_done)
    assert torch.equal(a.records[:a.nrec], b.records[:b.nrec])
    assert (a.state is None) == (b.state is None)
    if a.state is not None:
        assert torch.equal(a.state, b.state)


@pytest.fixture(scope="module")
def workload():
    return chip_smoke.slot_loop_workload(3, 200)


@pytest.mark.parametrize("fmt", ["bytes", "packed", "packed6"])
@pytest.mark.parametrize("same_file", [False, True])
@pytest.mark.parametrize("score", [True, False])
@pytest.mark.parametrize("n_calls", [40, 200])
def test_fused_loop_equals_torch_loop(workload, fmt, same_file, score,
                                      n_calls):
    genome, bank, meta, cstate = workload
    meta = tuple(m[:n_calls] for m in meta)
    eng = _engine(genome, bank, B=64, tb_format=fmt, same_file=same_file,
                  compute_score=score)
    assert eng.slots(n_calls) == 64
    want = eng._loop_torch(meta, cstate[:n_calls], 0)
    got = eng._loop_fused(meta, cstate[:n_calls], 0)
    _same(got, want)
    assert want.calls_done == n_calls and want.nrec > 0
    assert got.spans["engine_fused_iters"] == got.iters
    assert want.spans["engine_fused_iters"] == 0


@pytest.mark.parametrize("fmt", ["bytes", "packed6"])
def test_a_drained_first_tier_and_its_resumption_are_the_same(workload, fmt):
    """The drain stops both loops at the same iteration with the same
    exported state; the second tier from it is the same too, and the two
    tiers give the records of one loop run to its end."""
    genome, bank, meta, cstate = workload
    eng = _engine(genome, bank, B=64, tb_format=fmt, same_file=True)
    want = eng._loop_torch(meta, cstate, 16)
    got = eng._loop_fused(meta, cstate, 16)
    _same(got, want)
    assert 0 < got.calls_done < len(meta[0])
    state = got.state.numpy()
    idx = np.flatnonzero(state[:, tdb.DONE] == 0)
    rest = tuple(m[idx] for m in meta)
    want2 = eng._loop_torch(rest, state[idx], 0)
    got2 = eng._loop_fused(rest, state[idx], 0)
    _same(got2, want2)
    whole = eng._loop_torch(meta, cstate, 0)
    assert got.iters + got2.iters == whole.iters

    def rows(out):
        return out.records[:out.nrec].tolist()
    assert sorted(rows(got) + rows(got2)) == sorted(rows(whole))


def test_cpu_takes_the_torch_loop(workload):
    genome, bank, meta, cstate = workload
    eng = _engine(genome, bank, B=64)
    before = slot_loop.slot_prepare.launches, slot_loop.slot_post.launches
    out = eng._loop(meta, cstate, 0)
    assert out.iters > 0 and out.spans["engine_fused_iters"] == 0
    assert (slot_loop.slot_prepare.launches,
            slot_loop.slot_post.launches) == before


def test_state_round_trips_in_cstate_order(workload):
    """A loop the drain stops before its first iteration exports the
    state it was given, column for column in CSTATE_COLS order (flags as
    0/1)."""
    genome, bank, meta, _ = workload
    N = 40
    rng = np.random.default_rng(5)
    cstate = rng.integers(-1000, 1000, (N, 16)).astype(np.int32)
    flag = [i for i, c in enumerate(slot_loop.CSTATE_COLS)
            if c not in tdb._INT_COLS]
    cstate[:, flag] = rng.integers(0, 2, (N, len(flag)))
    eng = _engine(genome, bank, B=64)
    out = eng._loop_fused(tuple(m[:N] for m in meta), cstate, N + 1)
    assert out.iters == 0
    assert out.state.dtype == torch.int32
    np.testing.assert_array_equal(out.state.numpy(), cstate)
    assert slot_loop.CSTATE_COLS.index("done") == tdb.DONE
    assert tdb.CSTATE_COLS is slot_loop.CSTATE_COLS


@pytest.fixture
def meta_launches(monkeypatch):
    """The wrappers on meta tensors: the device check passes them and
    _build.launch records (entry, arguments)."""
    calls = []
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: t.device)
    monkeypatch.setattr(_build, "launch",
                        lambda entry, dev, *args: calls.append((entry,
                                                                args)))
    return calls


def test_signatures_hold_both_entries(meta_launches):
    N, B, W = 9, 4, 15
    m = dict(device="meta")
    I32, I64 = torch.int32, torch.int64
    cs = torch.empty((N + 1, 16), dtype=I32, **m)
    assign = torch.empty(B, dtype=I32, **m)
    lens = torch.empty((2, B), dtype=I32, **m)
    n = slot_loop.slot_prepare.launches, slot_loop.slot_post.launches
    slot_loop.slot_prepare(
        cs, torch.empty((N + 1, 8), dtype=I64, **m), assign,
        torch.empty(8, dtype=I64, **m),
        torch.empty((N + 1, 10), dtype=I32, **m),
        torch.empty((2, B), dtype=I64, **m), lens,
        torch.empty((2, B), dtype=torch.bool, **m), T=16, gap_diff=0,
        same_file=True, compute_score=True)
    out = {k: torch.empty(B, dtype=I32, **m)
           for k in ("max_i", "max_j", "max_score", "pos_score")}
    slot_loop.slot_post(cs, assign, lens, out,
                        torch.empty((B, W), dtype=torch.uint8, **m),
                        out["max_i"], out["max_j"], threshold=4,
                        compute_score=False, **SCORING)
    assert [e for e, _ in meta_launches] == ["dtt_slot_prepare",
                                             "dtt_slot_post"]
    for entry, args in meta_launches:
        # The stream is the last C argument, which launch appends.
        assert len(_build._SIGNATURES[entry]) == len(args) + 1, entry
    assert meta_launches[0][1][8:] == (N, B, 16, 0, 1, 1)
    assert meta_launches[1][1][10:] == (B, W, 4, 1, -1, -1, -1, 0)
    assert (slot_loop.slot_prepare.launches,
            slot_loop.slot_post.launches) == (n[0] + 1, n[1] + 1)
