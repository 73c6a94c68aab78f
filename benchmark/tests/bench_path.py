"""The benchmark's folder and the repository root on the import path for
the benchmark's own tests, each of which imports this module first, and
torch pinned to few threads (several test processes share the host)."""

import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
torch.set_num_threads(2)
