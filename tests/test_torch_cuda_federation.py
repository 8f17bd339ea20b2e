"""Vertically federated training on the card: 4 parties as column blocks,
every party's histogram on the kernel.  Skips without a card; on a
machine with one H100 (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_federation.py
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA not available)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vfl-histogram", "vfl-argmax-topk"])
def test_vfl_four_parties_on_card_equal_local_cuda(device, name):
    """At 2,000 rows (1,400 to train, 24 padded columns) and 3 rounds:
    P x levels x rounds round-histogram launches, and trees, leaves and
    final margins ``torch.equal`` to ``local-cuda`` on the same columns."""
    from repro_torch.core import backend as backend_mod
    from repro_torch.core import boosting, forest
    from repro_torch.data import synthetic, tabular
    from repro_torch.kernels.histogram import ops

    parties = 4
    ds = synthetic.load("default_credit_card", n=2000)
    x, d = tabular.pad_features(np.asarray(ds.x_train), parties)
    cfg = boosting.dynamic_fedgbf_config(rounds=3)
    masks = forest.draw_step_masks(cfg, x.shape[0], d,
                                   torch.Generator().manual_seed(0))
    local, local_h = boosting.train_fedgbf(x, ds.y_train, cfg, masks,
                                           backend="local-cuda",
                                           device=device)
    ops.reset_launches()
    model, hist = boosting.train_fedgbf(
        x, ds.y_train, cfg, masks, device=device,
        backend=backend_mod.get_backend(name, tree=cfg.tree,
                                        num_parties=parties))
    torch.cuda.synchronize()
    assert ops.kernel_launches("histogram_round") == \
        parties * cfg.tree.max_depth * cfg.rounds
    for a, b in zip(model.forests, local.forests):
        for f in ("feature", "threshold", "gain", "leaf_weight"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(hist.final_margin, local_h.final_margin)
