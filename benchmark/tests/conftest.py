"""CPU tests of the benchmark: run with ``python -m pytest benchmark/tests``
from the root of the repository."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
