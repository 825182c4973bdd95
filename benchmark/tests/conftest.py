"""CPU tests of the benchmark: run with ``python -m pytest benchmark/tests``
from the root of the repository.  torch runs on one intra-op thread: the
plain paths' small operations run faster so, and test workers do not
oversubscribe the cores."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(1)
