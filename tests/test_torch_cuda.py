"""The port's histogram kernel, training path, LM substrate and dry-run
on the card: ``chip_smoke.py``'s phases as tests.  They skip without a
card; on a machine with one H100 (no JAX needed):

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
    """Every histogram entry point equal to its plain version (max |diff|
    0), bit-identical across two launches, equal to the plain version on
    the CPU up to n = 21000; the sort kernel equal to its plain version."""
    chip_smoke, device = smoke
    err = chip_smoke.phase_hist_kernels(device)
    assert set(err) == {"histogram_round", "histogram_tree",
                        "histogram_staged", "histogram_sort"}
    assert max(err.values()) == 0.0


@pytest.mark.cuda
def test_training_paths_on_card(smoke):
    """60 round-histogram launches (each sorting first) build the
    checkpoint's 78 trees; the single-tree and staged entry points rebuild
    round 1."""
    chip_smoke, device = smoke
    train = chip_smoke.phase_train(device, chip_smoke.card_line())
    assert train["launches"]["histogram_round"] == 60
    assert train["launches"]["histogram_sort"] == 60
    assert chip_smoke.phase_other_paths(device, train) == {
        "histogram_tree": 15, "histogram_staged": 15}


@pytest.mark.cuda
def test_launchers_on_card(smoke):
    """train_fedgbf killed and resumed ends in the uninterrupted run's
    train state; --sampling goss trains; serve_fedgbf --save hands a model
    to serve_fedgbf --quantize 8 --metrics-port 0."""
    chip_smoke, device = smoke
    chip_smoke.phase_launchers(device)


@pytest.mark.cuda
def test_lm_smoke_configs_on_card(smoke):
    """Every architecture's smoke config, forward and token-by-token
    decode on the card in f32, within ``lm_smoke_atol`` of the committed
    JAX logits (phase 6c)."""
    chip_smoke, device = smoke
    assert chip_smoke.phase_lm_smoke(device) <= chip_smoke.LM_SMOKE_ATOL_RWKV


@pytest.mark.cuda
def test_dryrun_and_production_grid_on_card(smoke):
    """The dry-run's one-card case (phase 8a: a real SmolLM-135M train
    step's FLOPs equal the ``meta`` count, its state and peak memory agree)
    and the FedGBF production-grid sweep (8c: every meter reconciled,
    trees equal ``local-cuda``'s, one launch a level)."""
    chip_smoke, device = smoke
    card = chip_smoke.card_line()
    out = chip_smoke.phase_dryrun_card(device, card)
    assert abs(out["peak_ratio"] - 1) <= chip_smoke.PEAK_RTOL
    launches = chip_smoke.phase_dryrun_fedgbf(device, card)
    assert launches["histogram_round"] == launches["histogram_sort"] > 0
