"""The check has to come out false: for the control (the reference with
8-bit saturating cells in the program's place) and for each fault the
cells can have, planted underneath the timed path of a CPU run that skips
the harness's look for a card; in every cell and in the test-only map
cell."""

import pytest

from benchmark import harness
from benchmark.control import control_mismatches
from darwin_tpu_torch.engine import device_batch
from _cells import MAP, SEED, where

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]] + [MAP]
Engine = device_batch.DeviceGactEngine


def run(cell):
    return harness.run_cell(cell, SEED, 0.0, False, device="cpu",
                            **where(cell, SPEC))


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    r = control_mismatches(cell, SEED, "cpu", **where(cell, SPEC))
    assert r["reference_records"] >= 1 and r["record_mismatches"] > 0


def half_the_calls(monkeypatch):
    run_async = Engine.run_async

    def half(self, calls, complement, bank_ids=None):
        n = (len(calls) + 1) // 2
        keep = device_batch.GactCalls(calls.ref_id[:n], calls.query_id[:n],
                                      calls.ref_pos[:n], calls.query_pos[:n])
        comp = complement[:n] if hasattr(complement, "__len__") \
            else complement
        ids = None if bank_ids is None else bank_ids[:n]
        return run_async(self, keep, comp, ids)
    monkeypatch.setattr(Engine, "run_async", half)


def an_answer_altered(monkeypatch):
    records = Engine._records

    def altered(out):
        # One answer of the engine's output: the tiny cell's sample holds
        # every read, so it meets it.
        recs = records(out)
        if recs:
            recs[0].score += 1
        return recs
    monkeypatch.setattr(Engine, "_records", staticmethod(altered))


def state_unchanged(monkeypatch):
    align = device_batch.align_tiles

    def unchanged(*a, **kw):
        out = align(*a, **kw)
        return {k: v.zero_() if k != "dir" else v for k, v in out.items()}
    monkeypatch.setattr(device_batch, "align_tiles", unchanged)


@pytest.mark.parametrize("fault", [half_the_calls, an_answer_altered,
                                   state_unchanged])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run(cell)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["record_mismatches"]["value"] > 0
