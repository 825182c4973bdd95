"""The read generator against its parameters: length law, accuracy law,
error mix, strands, and what the names encode."""

import math

import numpy as np
import pytest

from benchmark import readgen

LAW = {"kind": "lognormal", "mean": 3000, "sd": 2300, "min": 100,
       "max": 25000, "coverage": 10}
ACC = {"mean": 0.85, "sd": 0.02, "min": 0.75, "max": 1.0}
RATIO = [1.50, 9.02, 4.49]
EXACT = {"mean": 1.0, "sd": 0, "min": 1.0, "max": 1.0}
G = 4_641_652


def test_lognormal_lengths_follow_the_law():
    L = readgen.read_lengths(LAW, G)
    assert L.sum() >= 10 * G > L.sum() - L.max()
    assert L.min() >= 100 and L.max() <= 25000
    # The law's own mean and spread: the bounds cut off almost nothing.
    assert L.mean() == pytest.approx(3000, rel=0.005)
    assert L.std() == pytest.approx(2300, rel=0.02)
    # Log-normal: log lengths spread as sigma = sqrt(ln(1 + cv^2)) says
    # (quartiles at +-0.6745 sigma), around ln(mean) - sigma^2 / 2.
    sigma = math.sqrt(math.log1p((2300 / 3000) ** 2))
    q1, q2, q3 = np.quantile(np.log(L), [0.25, 0.5, 0.75])
    assert (q3 - q1) / (2 * 0.6745) == pytest.approx(sigma, rel=0.01)
    assert q2 == pytest.approx(math.log(3000) - sigma**2 / 2, abs=0.01)


def test_lengths_outside_the_bounds_are_drawn_again():
    L = readgen.lognormal_lengths(3000, 2300, 2000, 4000, 2000)
    assert L.min() >= 2000 and L.max() <= 4000
    # Redrawn, not clipped: no pile of lengths at either bound.
    assert (L == 2000).sum() <= 2 and (L == 4000).sum() <= 2


def test_fixed_lengths_and_count():
    L = readgen.read_lengths({"kind": "fixed", "length": 10000,
                              "reads": 16384}, 10**8)
    assert len(L) == 16384 and (L == 10000).all()


def test_accuracies_follow_the_law():
    a = readgen.accuracies(ACC, 20000)
    assert a.min() >= 0.75 and a.max() <= 1.0
    assert a.mean() == pytest.approx(0.85, abs=1e-4)
    assert a.std() == pytest.approx(0.02, rel=0.01)
    assert (readgen.accuracies(EXACT, 5) == 1.0).all()


def test_every_seed_gets_the_same_lengths_in_another_order():
    g = readgen.genome(200_000, np.random.default_rng(0))
    L = readgen.read_lengths(dict(LAW, coverage=3), len(g))
    a = readgen.reads(g, L, np.random.default_rng(1), EXACT, RATIO, 0.5)[2]
    b = readgen.reads(g, L, np.random.default_rng(2), EXACT, RATIO, 0.5)[2]
    assert sorted(a) == sorted(b) and list(a) != list(b)


def test_error_rate_and_mix():
    g = readgen.genome(1_000_000, np.random.default_rng(3))
    L = readgen.read_lengths(dict(LAW, coverage=4), len(g))
    st = {}
    names, flat, nl = readgen.reads(g, L, np.random.default_rng(4), ACC,
                                    RATIO, 0.5, st)
    ev = st["sub"] + st["ins"] + st["dele"]
    # One error at most a base, with its read's 1 - accuracy.
    assert ev == pytest.approx(st["expected"], rel=0.01)
    assert ev / st["bases"] == pytest.approx(0.15, rel=0.01)
    w = sum(RATIO)
    assert st["sub"] / ev == pytest.approx(1.50 / w, abs=0.005)
    assert st["ins"] / ev == pytest.approx(9.02 / w, abs=0.005)
    assert st["dele"] / ev == pytest.approx(4.49 / w, abs=0.005)
    assert st["comp"] / len(L) == pytest.approx(0.5, abs=0.05)
    assert sorted(st["accuracy"]) == pytest.approx(
        readgen.accuracies(ACC, len(L)))
    assert nl.sum() == len(flat) == st["bases"] + st["ins"] - st["dele"]
    assert set(np.unique(flat).tobytes()) <= set(b"ACGT")


def test_a_read_takes_its_own_error_rate():
    g = readgen.genome(100_000, np.random.default_rng(9))
    L = np.full(40, 5000)
    acc = {"mean": 0.85, "sd": 0.1, "min": 0.7, "max": 1.0}
    st = {}
    _, _, nl = readgen.reads(g, L, np.random.default_rng(10), acc, [0, 1, 0],
                             0.0, st)
    # Insertions only: a read grows by its own error count.
    grown = (nl - 5000) / 5000
    assert np.corrcoef(grown, 1 - st["accuracy"])[0, 1] > 0.95


def test_error_free_reads_are_the_genome_or_its_reverse_complement():
    g = readgen.genome(50_000, np.random.default_rng(5))
    L = np.array([1000, 2500, 4000, 777])
    names, flat, nl = readgen.reads(g, L, np.random.default_rng(6), EXACT,
                                    RATIO, 0.5)
    comp = np.frombuffer(b"TGCA", dtype=np.uint8)
    at = 0
    for name, n in zip(names, nl):
        _, start, ln = name.split("_")[:3]
        s, ln = int(start), int(ln)
        want = (comp[g[s:s + ln]][::-1] if name.endswith("_c")
                else readgen.BASES[g[s:s + ln]])
        assert ln == n and (flat[at:at + n] == want).all()
        at += n


def test_substitutions_change_the_base_and_insertions_add_one():
    g = readgen.genome(20_000, np.random.default_rng(7))
    L = np.array([20_000 - 1])
    st = {}
    acc = {"mean": 0.95, "sd": 0, "min": 0.95, "max": 0.95}
    _, flat, nl = readgen.reads(g, L, np.random.default_rng(8), acc, RATIO,
                                0.0, st)
    assert nl[0] == L[0] + st["ins"] - st["dele"]
    _, flat, nl = readgen.reads(g, L, np.random.default_rng(8), acc,
                                [1, 0, 0], 0.0, st)
    assert nl[0] == L[0] and st["sub"] > 0
    assert (flat != readgen.BASES[g[:L[0]]]).sum() == st["sub"]
