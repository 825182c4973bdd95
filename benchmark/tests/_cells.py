"""Tiny scales of the cells for CPU runs of the harness."""

SCALES = {
    "ecoli10x_self": {"genome_length": 12000,
                      "lengths": {"mean": 1500, "sd": 600, "min": 800,
                                  "max": 3000, "coverage": 2}},
}
SEED = 2**31 + 4321
