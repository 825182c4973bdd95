"""darwin_tpu_torch PAF output against darwin_tpu.io.paf.

paf_line / paf_lines over the port's OverlapRecord must give the JAX
package's lines for the same records: both strands (comp=1 maps the
query span back to the read's strand), a record with no op-stream tally
(ncols == 0, block length from the spans) and --noscore records.
"""

import numpy as np

from darwin_tpu.engine.batch import OverlapRecord as JaxRecord
from darwin_tpu.io import paf as jax_paf
from darwin_tpu_torch.engine.batch import OverlapRecord
from darwin_tpu_torch.index.genome import Genome
from darwin_tpu_torch.io import paf
from darwin_tpu_torch.io.fasta import FastaRecord


def _records():
    rng = np.random.default_rng(8)
    recs = []
    for k in range(12):
        ab = int(rng.integers(0, 500))
        bb = int(rng.integers(0, 300))
        ae = ab + int(rng.integers(1, 400))
        be = bb + int(rng.integers(1, 300))
        ncols = 0 if k % 4 == 3 else max(ae - ab, be - bb) + k
        score = 0 if k % 5 == 4 else int(rng.integers(1, 300))
        recs.append((k % 3, (k + 1) % 4, ab, ae, bb, be, score,
                     bool(k % 2), score // 2, ncols))
    return recs


def test_paf_lines_match_jax():
    genome = Genome([FastaRecord([f"chr{i}"], "ACGT" * (200 + 50 * i))
                     for i in range(3)], 64)
    names = [f"read{i}" for i in range(4)]
    lens = [700, 650, 800, 720]
    rows = _records()
    got = paf.paf_lines([OverlapRecord(*r) for r in rows], genome, names,
                        lens)
    want = jax_paf.paf_lines([JaxRecord(*r) for r in rows], genome, names,
                             lens)
    assert got == want and len(got) == len(rows)
    assert any("\t-\t" in ln for ln in got) and any("\t+\t" in ln
                                                     for ln in got)
    r = rows[3]
    assert r[9] == 0
    assert paf.paf_line(OverlapRecord(*r), "chr0", 800, "read0", 700) == \
        jax_paf.paf_line(JaxRecord(*r), "chr0", 800, "read0", 700)
