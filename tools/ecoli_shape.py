"""Regenerate tests/data/ecoli_shape: the E.coli-shaped self-overlap
dataset's digest and the JAX package's record set for it.

    python tools/ecoli_shape.py [OUT_DIR]      (about a minute on a CPU)

The dataset is the repo's standard E.coli-shaped one (the
tools/scale_test.py recipe): a 4.6 Mb synthetic genome, 460 x 10 kb
reads at 12% error, half reverse-complemented, numpy seed 42,
self-overlap with default Params (tile 320).  It writes

* dataset.sha256 -- sha256 of the reads FASTA as io.fasta.write_fasta
  writes it;
* jax_cpu.darwin -- the sorted-unique record lines of
  darwin_tpu.pipeline.run_pipeline(engine="device", backend="lax") on
  the CPU.  These come from darwin_tpu, not from the reference binary.

chip_smoke.py rebuilds the dataset, checks the digest and holds the
PyTorch port's merged output to jax_cpu.darwin.
"""

from __future__ import annotations

import hashlib
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import darwin_tpu  # noqa: F401,E402  (THP madvise guard)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from darwin_tpu.config import Params  # noqa: E402
from darwin_tpu.eval.datagen import sample_reads, synth_genome  # noqa: E402
from darwin_tpu.io.fasta import parse_fasta, write_fasta  # noqa: E402
from darwin_tpu.pipeline import run_pipeline  # noqa: E402


def main() -> int:
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else (
        REPO / "tests/data/ecoli_shape")
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(42)
    genome = synth_genome(4_600_000, rng)
    reads = sample_reads(genome, 460, 10_000, rng, error_rate=0.12,
                         rc_fraction=0.5)
    with tempfile.TemporaryDirectory() as td:
        fa = Path(td) / "reads.fasta"
        write_fasta(fa, reads)
        digest = hashlib.sha256(fa.read_bytes()).hexdigest()
        recs = parse_fasta(fa)
    t0 = time.time()
    res = run_pipeline(recs, recs, Params(), same_file=True,
                       batch_size=512, engine="device", backend="lax")
    lines = sorted(set(res.records))
    (out / "dataset.sha256").write_text(digest + "\n")
    (out / "jax_cpu.darwin").write_text("".join(x + "\n" for x in lines))
    print(f"{len(lines)} records, candidates "
          f"{res.num_candidates_for}+{res.num_candidates_rev}, "
          f"{time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
