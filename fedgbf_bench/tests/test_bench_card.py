"""On the card: one short run of a cell through ``run.py``, as the check
runs it.  Skips without a CUDA card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, "fedgbf_bench/run.py", "--workload",
         "credit.train.local", "--seed", "4000000001", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=360,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
