"""The benchmark's CPU tests run from the root of the repository:
``python -m pytest fedgbf_bench/tests``."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# the tests drive the program on the CPU beside other test workers: one
# thread each keeps them from thrashing
torch.set_num_threads(1)
