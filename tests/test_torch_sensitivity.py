"""darwin_tpu_torch.eval.sensitivity (the port's copy of darwin_tpu's
sensitivity / specificity evaluator) against darwin_tpu's, mirroring
tests/test_sensitivity.py: the interval rule, the counts with AB->BA
mirroring and the score filter, the guided mode's best-per-read rule,
datagen's read names, every fixture's out.darwin through both
evaluators and both command lines, and the port's pipeline in the
guided flow (on the CPU)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from darwin_tpu.eval import sensitivity as jsens
from darwin_tpu_torch.config import Params
from darwin_tpu_torch.eval.datagen import sample_reads, synth_genome
from darwin_tpu_torch.eval.sensitivity import (measure_sensitivity,
                                               measure_sensitivity_guided,
                                               theoretical_overlaps)
from darwin_tpu_torch.golden.gact import format_record
from darwin_tpu_torch.io.fasta import parse_fasta
from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
FIXTURES = sorted(p.parent.name for p in DATA.glob("*/out.darwin"))


def _counts(res):
    return (res.tp, res.fn, res.fp, res.sensitivity, res.specificity)


def test_theoretical_overlaps_interval_rule():
    names = ["R0_0_2000", "R1_1500_2000", "R2_2600_1000", "R3_9000_500"]
    assert theoretical_overlaps(names) == []
    got = set(theoretical_overlaps(names, min_overlap=400))
    assert got == {(0, 1), (1, 0), (1, 2), (2, 1)}
    for kw in ({}, dict(min_overlap=400), dict(remove_trivial=False)):
        assert theoretical_overlaps(names, **kw) == \
            jsens.theoretical_overlaps(names, **kw)


def test_measure_sensitivity_counts():
    names = ["R0_0_2000", "R1_500_2000"]
    rec_hit = format_record("R0_0_2000", "R1_500_2000",
                            500, 1999, 0, 1499, 700, 0)
    res = measure_sensitivity([rec_hit], names)
    assert (res.tp, res.fn, res.fp) == (2, 0, 0)
    assert res.sensitivity == 1.0
    rec_low = format_record("R0_0_2000", "R1_500_2000",
                            500, 1999, 0, 1499, 100, 0)
    res = measure_sensitivity([rec_low], names)
    assert (res.tp, res.fn) == (0, 2)
    names_fp = ["R0_0_2000", "R1_50000_2000"]
    res = measure_sensitivity([rec_hit], names_fp)
    assert res.fp == 2 and res.tp == 0
    for recs, nm in (([rec_hit], names), ([rec_low], names),
                     ([rec_hit], names_fp)):
        for kw in ({}, dict(extra=False), dict(score_thres=50)):
            assert _counts(measure_sensitivity(recs, nm, **kw)) == \
                _counts(jsens.measure_sensitivity(recs, nm, **kw))


def test_datagen_names_roundtrip():
    import re
    rng = np.random.default_rng(0)
    g = synth_genome(5000, rng)
    reads = sample_reads(g, 5, 1000, rng, error_rate=0.05)
    for i, (name, seq) in enumerate(reads):
        rid, pos, length = [int(x) for x in re.findall(r"\d+", name)]
        assert rid == i
        assert 0 <= pos < 5000
        assert length == len(seq)


def test_measure_sensitivity_guided_counts():
    ok = format_record("genome1", "R0_1200_1000", 1210, 2150, 5, 950,
                       800, 0)
    off = format_record("genome1", "R1_4000_1000", 6000, 6900, 0, 900,
                        900, 0)
    low = format_record("genome1", "R2_7000_1000", 7010, 7900, 0, 890,
                        100, 0)
    res = measure_sensitivity_guided([ok, off, low], num_reads=4)
    assert (res.tp, res.fp, res.fn) == (1, 1, 2)
    far = format_record("genome1", "R0_1200_1000", 9000, 9900, 0, 900,
                        700, 0)
    res = measure_sensitivity_guided([far, ok], num_reads=1)
    assert (res.tp, res.fp, res.fn) == (1, 0, 0)
    for recs, n in (([ok, off, low], 4), ([far, ok], 1)):
        for kw in ({}, dict(window=5000), dict(score_thres=50)):
            assert _counts(measure_sensitivity_guided(recs, n, **kw)) == \
                _counts(jsens.measure_sensitivity_guided(recs, n, **kw))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_records_evaluate_as_in_jax(name):
    """The reference binary's records of every fixture through both
    evaluators: guided, and de novo where the reads are their own
    reference with names that carry their coordinates."""
    d = DATA / name
    recs = sorted(set((d / "out.darwin").read_text().splitlines()))
    names = [r.name for r in parse_fasta(d / "reads.fasta", native=False)]
    if not (d / "ref.fasta").exists() and all(
            len(jsens._ints(n)) >= 3 for n in names):
        assert _counts(measure_sensitivity(recs, names)) == \
            _counts(jsens.measure_sensitivity(recs, names))
    assert _counts(measure_sensitivity_guided(recs, len(names))) == \
        _counts(jsens.measure_sensitivity_guided(recs, len(names)))


def test_sensitivity_command_line_prints_jax_lines():
    """python -m darwin_tpu_torch.eval.sensitivity prints darwin_tpu's
    lines on the noisy fixture, de novo and --guided."""
    d = DATA / "noisy"
    for extra in ([], ["--guided", "--window", "60"]):
        args = [str(d / "out.darwin"), str(d / "reads.fasta"), *extra]
        out = [subprocess.run(
            [sys.executable, "-m", mod, *args], capture_output=True,
            text=True, cwd=REPO, timeout=300)
            for mod in ("darwin_tpu_torch.eval.sensitivity",
                        "darwin_tpu.eval.sensitivity")]
        assert out[0].returncode == 0, out[0].stderr[-2000:]
        assert out[0].stdout == out[1].stdout
        assert "sensitivity:" in out[0].stdout


def test_pipeline_guided_mapping_accuracy():
    """Reference-guided flow on the port (CPU): reads sampled from a
    genome, mapped back (same_file=False) by run_pipeline, evaluated in
    guided mode, with darwin_tpu's evaluator agreeing."""
    from darwin_tpu_torch.io.fasta import FastaRecord
    from darwin_tpu_torch.pipeline import run_pipeline

    rng = np.random.default_rng(7)
    genome = synth_genome(60000, rng)
    reads = sample_reads(genome, 8, 3000, rng, error_rate=0.08)
    params = Params(tile_size=64, tile_overlap=24,
                    first_tile_score_threshold=10, threshold=15)
    ref_recs = [FastaRecord(["genome1"], genome)]
    read_recs = [FastaRecord([n], s) for n, s in reads]
    result = run_pipeline(ref_recs, read_recs, params, same_file=False,
                          batch_size=64, device="cpu")
    res = measure_sensitivity_guided(result.records, len(reads),
                                     score_thres=600)
    assert res.tp >= 6, (res.tp, res.fn, res.fp)
    assert res.fp == 0
    assert _counts(res) == _counts(jsens.measure_sensitivity_guided(
        result.records, len(reads), score_thres=600))
