"""GOSS training, kill-and-resume and quantized serving on the card:
``chip_smoke.py``'s phases 2b', 3b, 4b and 4c as tests.  They skip without
a card; on a machine with one H100 (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda \\
        tests/test_torch_cuda_goss_quantized.py
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
def test_goss_weights_histogram_on_card(smoke):
    """The round histogram on GOSS's fractional weights equals its plain
    version bit for bit (phase 2b')."""
    chip_smoke, device = smoke
    assert chip_smoke.phase_goss_hist_kernels(device) == 0.0


@pytest.mark.cuda
def test_goss_training_and_resume_on_card(smoke):
    """GOSS training through 60 histogram launches equals local on the
    card; the reference run killed after round 8 and resumed equals the
    uninterrupted run (phases 4b and 4c)."""
    chip_smoke, device = smoke
    card = chip_smoke.card_line()
    train = chip_smoke.phase_train(device, card)
    goss = chip_smoke.phase_goss_train(device, card, train["history"])
    assert goss["launches"]["histogram_round"] == 60
    resume = chip_smoke.phase_resume(device, card, train)
    assert resume["launches"]["histogram_round"] == 60


@pytest.mark.cuda
def test_quantized_serving_on_card(smoke):
    """The JAX int8/int16 checkpoints serve through both traversal kernels
    with the JAX margins, within the bound (phase 3b)."""
    chip_smoke, device = smoke
    card = chip_smoke.card_line()
    launches = chip_smoke.phase_quantized(
        device, card, chip_smoke.phase_main_path(device, card))
    assert launches["ensemble_predict_raw"] == 2 * 129
    assert launches["ensemble_predict_binned"] == 2 * 9
