"""Small shared helpers; the port's copy of darwin_tpu/utils.py's
bucket_steps."""

from __future__ import annotations


def bucket_steps(n: int, lo: int = 64) -> int:
    """Smallest value >= n from {lo*2^k, lo*3*2^(k-1)}.

    Half-octave buckets: at most 33% padding waste instead of a power
    of two's 50% -- used for the engine's slot count, where idle slots
    cost real per-iteration work.
    """
    b = lo
    while b < n:
        if b * 3 // 2 >= n:
            return b * 3 // 2
        b *= 2
    return b
