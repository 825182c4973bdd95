"""Synthetic dataset generation for tests and benchmarks.

The port's copy of darwin_tpu/eval/datagen.py's synth_genome,
sample_reads and two_readsets (chip_smoke.py's datasets and
tools/torch_profile_ecoli.py's).  Python-3 re-design of the reference's
generateperfect.py: reads sampled from a random genome, optionally with
PBSIM-like errors, with the origin coordinates encoded in the read name
as a single alnum/underscore token ``R<id>_<genome_pos>_<len>[_c]`` so
the sensitivity evaluator can recompute ground-truth overlaps (reference
generateperfect.py:86-106, measure_sensitivity_PBSIM.py:86-106).
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def synth_genome(length: int, rng: np.random.Generator) -> str:
    return _BASES[rng.integers(0, 4, size=length)].tobytes().decode("ascii")


def _mutate(seq: np.ndarray, rate: float, rng: np.random.Generator
            ) -> np.ndarray:
    """Apply substitutions/insertions/deletions at the given total rate
    (45% sub, 30% ins, 25% del, roughly PBSIM CLR-like)."""
    if rate <= 0:
        return seq
    out: list[np.ndarray] = []
    pos = 0
    n = len(seq)
    # Sample event positions.
    nev = rng.poisson(rate * n)
    ev_pos = np.sort(rng.integers(0, n, size=nev))
    ev_type = rng.random(nev)
    for p, t in zip(ev_pos, ev_type):
        if p < pos:
            continue
        out.append(seq[pos:p])
        if t < 0.45:  # substitution
            out.append(np.array(
                [_BASES[(np.searchsorted(_BASES, seq[p]) + 1 +
                         rng.integers(0, 3)) % 4]], dtype=np.uint8))
            pos = p + 1
        elif t < 0.75:  # insertion
            out.append(np.array([seq[p]], dtype=np.uint8))
            out.append(_BASES[rng.integers(0, 4, size=1)])
            pos = p + 1
        else:  # deletion
            pos = p + 1
    out.append(seq[pos:])
    return np.concatenate(out)


def two_readsets(genome: str, num_reads: int, read_len: int,
                 rng: np.random.Generator, error_rate: float = 0.0,
                 rc_fraction: float = 0.0
                 ) -> tuple[list[tuple[str, str]], list[tuple[str, str]]]:
    """Two independent read sets sampled from one genome for de-novo
    two-file alignment (generateperfect.py:75-106); names are the
    origin-encoding ``R<i>_<start>_<len>[_c]`` convention so both the
    sensitivity and score evaluators can recover ground truth.
    """
    a = sample_reads(genome, num_reads, read_len, rng,
                     error_rate=error_rate, rc_fraction=rc_fraction)
    b = sample_reads(genome, num_reads, read_len, rng,
                     error_rate=error_rate, rc_fraction=rc_fraction)
    return a, b


def sample_reads(genome: str, num_reads: int, read_len: int,
                 rng: np.random.Generator, error_rate: float = 0.0,
                 rc_fraction: float = 0.0,
                 read_len_range: tuple[int, int] | None = None,
                 ) -> list[tuple[str, str]]:
    """Sample reads; returns [(name, seq)] with origin-encoding names.

    read_len_range=(lo, hi) draws each read's length uniformly from
    [lo, hi] (long-read length spread); default keeps the fixed
    read_len AND the exact RNG stream of earlier rounds' fixtures.
    """
    g = np.frombuffer(genome.encode("ascii"), dtype=np.uint8)
    reads: list[tuple[str, str]] = []
    for i in range(num_reads):
        rl = (read_len if read_len_range is None
              else int(rng.integers(read_len_range[0],
                                    read_len_range[1] + 1)))
        start = int(rng.integers(0, max(1, len(g) - rl)))
        chunk = g[start:start + rl]
        comp = rng.random() < rc_fraction
        if comp:
            chunk = (np.frombuffer(b"TGCA", dtype=np.uint8)
                     [np.searchsorted(_BASES, chunk)])[::-1]
        chunk = _mutate(chunk, error_rate, rng)
        name = f"R{i}_{start}_{len(chunk)}" + ("_c" if comp else "")
        reads.append((name, chunk.tobytes().decode("ascii")))
    return reads
