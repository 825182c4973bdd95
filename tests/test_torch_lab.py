"""The kernel lab's entry points (darwin_tpu_torch.lab) at a tiny size
on the CPU, where every kernel runs its plain version.  The sinks are
held against the JAX tools in test_torch_plane2.py and
test_torch_scanshift.py; here each entry point must run, check what it
checks, and refuse a missing card."""

import pytest
import torch

from darwin_tpu_torch import lab
from darwin_tpu_torch.lab import (geom_sweep, kernel_lab, plane2_probe,
                                  scanshift_probe)
from tests._torch_threads import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]


def test_geom_sweep(capsys):
    assert geom_sweep.main(CPU + ["--config", "8,24,packed6,2",
                                  "--config", "8,24,bytes,4",
                                  "--config", "4,16,packed,1"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK ") == 3 and "3/3 configs exact" in out


def test_geom_sweep_matrix_has_every_format_and_interleave():
    m = geom_sweep.DEFAULT_MATRIX
    assert {f for _, _, f, _ in m} == {"bytes", "packed", "packed6"}
    assert {il for *_, il in m} == {1, 2, 4}
    assert len(set(m)) == len(m)


def test_kernel_lab(capsys):
    assert kernel_lab.main(["base", "byte_full", "packed_dp", "packed6",
                            "ilp", "tbiters", *CPU, "--batch", "8",
                            "--tile", "24", "--et", "16",
                            "--variants", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    ilp = [ln.split("sink ")[1] for ln in lines if "interleave=" in ln]
    assert len(ilp) == 3 and len(set(ilp)) == 1  # same words for all N
    assert any(ln.startswith("tb iterations used") for ln in lines)


def test_kernel_lab_refuses_word_walker_experiments(capsys):
    """The word-walker experiments are ported now (next test); what the
    lab still refuses is an experiment it does not know."""
    assert kernel_lab.main(["tbunroll2", *CPU]) == 2
    assert "unknown experiment 'tbunroll2'" in capsys.readouterr().err
    assert {"packed", "packed6", "p6compact",
            "tbunroll"} <= set(kernel_lab.EXPERIMENTS)


def test_kernel_lab_word_walkers(capsys):
    """The tool's packed, packed6, p6compact and tbunroll experiments on
    the plain walkers: every full step's sink is the byte step's (the
    walkers give the same ops and steps), whatever compact_b or unroll."""
    assert kernel_lab.main(["byte_full", "packed", "packed6", "p6compact",
                            "tbunroll", *CPU, "--batch", "8", "--tile",
                            "24", "--et", "16", "--variants", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    sinks = {ln.split(":")[0]: ln.split("sink ")[1].split()[0]
             for ln in lines}
    full = [k for k in sinks if "step" in k or "compact_b" in k]
    assert len(full) == 1 + 1 + 1 + 5 + 4, sinks
    assert len({sinks[k] for k in full}) == 1
    assert "packed6 dp_only" in sinks


@pytest.mark.parametrize("which", ["emit", "gather"])
def test_plane2_probe(which, capsys):
    assert plane2_probe.main([which, "24", *CPU, "--batch", "16",
                              "--variants", "2"]) == 0
    assert capsys.readouterr().out.count(f"{which} ") == (
        2 if which == "emit" else 3)


def test_scanshift_probe(capsys):
    assert scanshift_probe.main(["24", *CPU, "--batch", "16",
                                 "--variants", "2"]) == 0
    assert "agree with torch.cummax" in capsys.readouterr().out


def test_cuda_device_required(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        scanshift_probe.main(["24", "--batch", "4", "--variants", "1"])
    assert lab.resolve_device("cpu").type == "cpu"


def test_sum32_wraps_like_int32():
    t = torch.tensor([2 ** 31 - 1, 1, 2 ** 31], dtype=torch.int64)
    assert lab.sum32(t) == 0  # 2**32
    assert lab.sum32(t[:2]) == -(2 ** 31)
    assert lab.wrap32(-(2 ** 31) - 1) == 2 ** 31 - 1
