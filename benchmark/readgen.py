"""Synthetic genomes and long reads from a seed, in bulk.

PBSIM's model-based simulation (Ono, Asai and Hamada, Bioinformatics
29(1):119-121, 2013; its README's options), vectorised over a whole read
set:

* a read's length follows a log-normal law of the given mean and
  standard deviation (--length-mean, --length-sd), a length outside
  [min, max] drawn again (--length-min, --length-max);
* a read's accuracy follows a normal law (--accuracy-mean,
  --accuracy-sd), a value outside [min, max] drawn again;
* each base of a read independently takes one error with probability
  1 - accuracy, a substitution (the base becomes one of the three
  others), an insertion (a random base after it) or a deletion, in the
  ratio --difference-ratio (substitution:insertion:deletion).

A read starts uniformly in the genome and is reverse complemented with
probability rc_fraction.  Its name encodes its origin as
``R<i>_<start>_<len>[_c]``.  Over a reference of several pieces, the
reads split over the pieces in proportion to their lengths (shares), and
the harness names each by its piece p as ``c<p>R<i>_...``.

Lengths and accuracies are the same sets for every seed: the quantiles
of their laws at (i + 0.5) / n, for the smallest n whose lengths reach
the coverage (or a fixed count); the seed only shuffles them, each on
its own.  So two seeds give the same amount of work, in another order
and at other places.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
STD = NormalDist()


def genome(length: int, rng: np.random.Generator) -> np.ndarray:
    """Uniform random bases (codes 0-3)."""
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def truncated_normal_quantiles(mu: float, sigma: float, lo: float,
                               hi: float, n: int) -> np.ndarray:
    """n stratified quantiles of a normal law redrawn outside [lo, hi]."""
    a, b = STD.cdf((lo - mu) / sigma), STD.cdf((hi - mu) / sigma)
    return np.array([mu + sigma * STD.inv_cdf(a + (b - a) * (i + 0.5) / n)
                     for i in range(n)])


def lognormal_lengths(mean: float, sd: float, lo: int, hi: int,
                      n: int) -> np.ndarray:
    """n stratified quantiles of PBSIM's length law: log-normal of the
    given mean and standard deviation, redrawn outside [lo, hi]."""
    var = math.log1p((sd / mean) ** 2)
    mu, sigma = math.log(mean) - var / 2, math.sqrt(var)
    z = truncated_normal_quantiles(mu, sigma, math.log(lo), math.log(hi), n)
    return np.clip(np.rint(np.exp(z)), lo, hi).astype(np.int64)


def read_lengths(law: dict, genome_len: int) -> np.ndarray:
    """The cell's length set, ascending: law["kind"] is "fixed" (every
    read law["length"]) or "lognormal" (mean, sd, min, max); with
    law["coverage"] as many reads as reach it, else law["reads"]."""
    if law["kind"] == "fixed":
        one = lambda n: np.full(n, law["length"], dtype=np.int64)  # noqa: E731
    elif law["kind"] == "lognormal":
        one = lambda n: lognormal_lengths(  # noqa: E731
            law["mean"], law["sd"], law["min"], law["max"], n)
    else:
        raise ValueError(f"length law {law['kind']!r}")
    if "reads" in law:
        return np.sort(one(law["reads"]))
    target = law["coverage"] * genome_len
    n = max(1, math.ceil(target / one(4096).mean()))
    while one(n).sum() < target:
        n += 1
    while n > 1 and one(n - 1).sum() >= target:
        n -= 1
    return np.sort(one(n))


def shares(n: int, sizes) -> np.ndarray:
    """n reads split over pieces in proportion to their sizes: each
    piece's whole share, the rest one each to the largest fractions
    (ties to the first piece)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    exact = n * sizes / sizes.sum()
    out = np.floor(exact).astype(np.int64)
    extra = np.argsort(out - exact, kind="stable")[:n - out.sum()]
    out[extra] += 1
    return out


def accuracies(law: dict, n: int) -> np.ndarray:
    """n stratified quantiles of the accuracy law (mean, sd, min, max),
    ascending."""
    if law["sd"] == 0:
        return np.full(n, float(law["mean"]))
    return truncated_normal_quantiles(law["mean"], law["sd"], law["min"],
                                      law["max"], n)


def reads(g: np.ndarray, lengths: np.ndarray, rng: np.random.Generator,
          accuracy: dict, ratio, rc_fraction: float,
          stats: dict | None = None
          ) -> tuple[list[str], np.ndarray, np.ndarray]:
    """Reads of the given lengths (in the rng's order) from genome codes
    g: (names, flat ASCII bases, read lengths after the errors).
    accuracy is the accuracy law, ratio the substitution, insertion and
    deletion weights.  stats, where given, gets the source bases, the
    expected errors and the events of each kind."""
    lengths = rng.permutation(lengths)
    n, G = len(lengths), len(g)
    acc = rng.permutation(accuracies(accuracy, n))
    start = rng.integers(0, np.maximum(1, G - lengths))
    comp = rng.random(n) < rc_fraction
    # Source bases of every read, reverse complemented where comp.
    total = int(lengths.sum())
    rstart = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    src = np.empty(total, dtype=np.uint8)
    for s, ln, at, c in zip(start.tolist(), lengths.tolist(),
                            rstart.tolist(), comp.tolist()):
        src[at:at + ln] = 3 - g[s:s + ln][::-1] if c else g[s:s + ln]
    # One error at most a base, with its read's probability 1 - accuracy.
    err = np.repeat((1.0 - acc).astype(np.float32), lengths)
    ev = np.flatnonzero(rng.random(total, dtype=np.float32) < err)
    del err
    w = np.asarray(ratio, dtype=np.float64)
    kind = np.searchsorted(np.cumsum(w / w.sum()), rng.random(len(ev)),
                           side="right")
    sub, ins, dele = ev[kind == 0], ev[kind == 1], ev[kind >= 2]
    src[sub] = (src[sub] + 1 + rng.integers(0, 3, len(sub))) % 4
    keep = np.ones(total, dtype=bool)
    keep[dele] = False
    # An inserted base follows its own base, which lands where the
    # deletions before it shift it.
    out = np.insert(src[keep], ins - np.searchsorted(dele, ins) + 1,
                    rng.integers(0, 4, len(ins), dtype=np.uint8))
    bounds = np.append(rstart, total)
    new_len = (lengths + np.diff(np.searchsorted(ins, bounds))
               - np.diff(np.searchsorted(dele, bounds)))
    if stats is not None:
        stats.update(bases=total, expected=float(((1 - acc) * lengths).sum()),
                     sub=len(sub), ins=len(ins), dele=len(dele),
                     comp=int(comp.sum()), accuracy=acc)
    names = [f"R{i}_{s}_{ln}" + ("_c" if c else "")
             for i, (s, ln, c) in enumerate(zip(start.tolist(),
                                                new_len.tolist(),
                                                comp.tolist()))]
    return names, BASES[out], new_len
