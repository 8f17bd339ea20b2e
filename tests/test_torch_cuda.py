"""The port's histogram kernel and training path on the card:
``chip_smoke.py``'s phases as tests.  They skip without a card; on a
machine with one H100 (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke():
    """(chip_smoke module, the card), or a skip: decided when the test
    runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA not available)")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke, torch.device("cuda", 0)


@pytest.mark.cuda
def test_histogram_kernel_on_card(smoke):
    """Every histogram entry point within 1e-5 of its plain version,
    bit-identical across two launches, equal to the plain version on the
    CPU up to n = 21000."""
    chip_smoke, device = smoke
    err = chip_smoke.phase_hist_kernels(device)
    assert max(err.values()) <= chip_smoke.HIST_TOL


@pytest.mark.cuda
def test_training_paths_on_card(smoke):
    """60 round-histogram launches build the checkpoint's 78 trees; the
    single-tree and staged entry points rebuild round 1."""
    chip_smoke, device = smoke
    train = chip_smoke.phase_train(device, chip_smoke.card_line())
    assert train["launches"]["histogram_round"] == 60
    assert chip_smoke.phase_other_paths(device, train) == {
        "histogram_tree": 15, "histogram_staged": 15}


@pytest.mark.cuda
def test_launchers_on_card(smoke):
    """train_fedgbf --backend local-cuda writes what serve_fedgbf serves."""
    chip_smoke, _ = smoke
    chip_smoke.phase_launchers()
