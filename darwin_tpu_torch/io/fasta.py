"""FASTA parsing and writing.

The port's copy of darwin_tpu/io/fasta.py, whose native loader is the
port's own build of the host library (darwin_tpu_torch/native.py).
Parity contract with the reference parser (fasta.cpp:19-98):

* Description lines are split into alnum/underscore tokens; every other
  character is a separator (fasta.cpp:19-33).  The first token is the
  record name used in overlap output records.  Consecutive separators
  produce empty tokens exactly like the reference.
* The reference *requires* sequence lines wrapped at 70 chars
  (fasta.cpp:83-87); this parser accepts any wrapping (strictly more
  permissive, identical on valid inputs).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable

import numpy as np

SEQLINE_WRAP_LEN = 70  # reference fasta.h:19


@dataclasses.dataclass
class FastaRecord:
    fields: list[str]      # tokenized description, fields[0] is the name
    seq: str

    @property
    def name(self) -> str:
        return self.fields[0]


def split_fields(descrip_line: str) -> list[str]:
    """Tokenize a '>' description line (reference fasta.cpp:19-33).

    The leading '>' is skipped; every non-[A-Za-z0-9_] character ends
    the current token (possibly emitting an empty one).
    """
    fields: list[str] = []
    cur: list[str] = []
    for ch in descrip_line[1:]:
        if ch.isalnum() or ch == "_":
            cur.append(ch)
        else:
            fields.append("".join(cur))
            cur = []
    fields.append("".join(cur))
    return fields


def parse_fasta(path: str | Path, *, native: bool | None = None
                ) -> list[FastaRecord]:
    """Parse a FASTA file into records.

    ``native=None`` (default) uses the native loader when the port's
    host library is built and falls back to the pure parser below -- on
    parse errors too, so error messages always come from the
    reference-parity path.  ``native=True`` raises without the library;
    ``native=False`` takes the pure parser.
    """
    if native is None or native:
        from darwin_tpu_torch import native as nat
        if nat.available():
            records = nat.parse_fasta(path)
            if records is not None:
                return records
        elif native:
            raise RuntimeError("native FASTA loader unavailable")
    return list(iter_fasta(path))


def iter_fasta(path: str | Path):
    """Stream records one at a time (the pure parser); bounds memory
    for read sets larger than RAM."""
    fields: list[str] | None = None
    chunks: list[str] = []
    # newline='\n': split on LF only, like the native loader and the
    # reference's getline (fasta.cpp:53) -- a classic-Mac CR-only file
    # must parse identically on every path.
    with open(path, newline="\n") as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            if line[0] == ">":
                if fields is not None:
                    yield FastaRecord(fields, "".join(chunks))
                fields = split_fields(line)
                chunks = []
            else:
                if fields is None:
                    raise ValueError(
                        f"{path}: file begins with non-description line")
                chunks.append(line)
    if fields is not None:
        yield FastaRecord(fields, "".join(chunks))


def check_reference_wrap(path: str | Path) -> bool:
    """True iff the file obeys the reference's 70-char wrap rule."""
    last_len = SEQLINE_WRAP_LEN
    with open(path, newline="\n") as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            if line[0] == ">":
                last_len = SEQLINE_WRAP_LEN
            else:
                if len(line) > SEQLINE_WRAP_LEN or (
                        len(line) < SEQLINE_WRAP_LEN
                        and last_len != SEQLINE_WRAP_LEN):
                    return False
                last_len = len(line)
    return True


def write_fasta(path: str | Path, records: Iterable[tuple[str, str]],
                wrap: int = SEQLINE_WRAP_LEN) -> None:
    """Write records as (name, seq) pairs, wrapped for the reference."""
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), wrap):
                f.write(seq[i:i + wrap] + "\n")


_NT = "acgtACGTnN"
_COMP = str.maketrans(_NT, "tgcaTGCAnN")
_COMP_BYTES = bytes.maketrans(_NT.encode(), b"tgcaTGCAnN")


def revcomp(seq: str) -> str:
    """Reverse complement (reference darwin.cpp:110-147).

    The reference aborts on characters outside acgtACGTnN; this raises.
    """
    bad = set(seq) - set(_NT)
    if bad:
        raise ValueError(f"Bad Nt char: {sorted(bad)[0]}")
    return seq.translate(_COMP)[::-1]


def revcomp_flat(flat: bytes | bytearray, lengths: np.ndarray) -> np.ndarray:
    """revcomp of every sequence of a batch in one pass: flat holds the
    sequences' ASCII bytes back to back (lengths), and the result their
    reverse complements back to back in the same order, as uint8.  The
    same bytes as revcomp a sequence at a time, and revcomp's ValueError
    for the first sequence that holds a character outside acgtACGTnN."""
    if flat.translate(None, _NT.encode()):
        ends = np.cumsum(lengths)
        for s, e in zip((ends - lengths).tolist(), ends.tolist()):
            revcomp(flat[s:e].decode("ascii"))
    # The whole batch reversed holds the sequences' reverse complements
    # in reverse order: put them back in order.
    rev = np.frombuffer(flat.translate(_COMP_BYTES), np.uint8)[::-1]
    parts = np.split(rev, np.cumsum(lengths[::-1])[:-1])
    return np.concatenate(parts[::-1])
