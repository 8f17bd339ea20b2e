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
    one round-histogram launch a level for all P parties (levels x rounds
    in all), and trees, leaves and final margins ``torch.equal`` to
    ``local-cuda`` on the same columns."""
    from repro_torch.core import backend as backend_mod
    from repro_torch.core import boosting, forest, prng
    from repro_torch.data import synthetic, tabular
    from repro_torch.kernels.histogram import ops

    parties = 4
    ds = synthetic.load("default_credit_card", n=2000)
    x, d = tabular.pad_features(np.asarray(ds.x_train), parties)
    cfg = boosting.dynamic_fedgbf_config(rounds=3)
    masks = forest.draw_step_masks(cfg, x.shape[0], d,
                                   prng.PRNGKey(0, device))
    local, local_h = boosting.train_fedgbf(x, ds.y_train, cfg, masks=masks,
                                           backend="local-cuda",
                                           device=device)
    ops.reset_launches()
    model, hist = boosting.train_fedgbf(
        x, ds.y_train, cfg, masks=masks, device=device,
        backend=backend_mod.get_backend(name, tree=cfg.tree,
                                        num_parties=parties))
    torch.cuda.synchronize()
    assert ops.kernel_launches("histogram_round") == \
        cfg.tree.max_depth * cfg.rounds
    for a, b in zip(model.forests, local.forests):
        for f in ("feature", "threshold", "gain", "leaf_weight"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(hist.final_margin, local_h.final_margin)


@pytest.mark.cuda
def test_vfl_runtime_on_card_equal_oracles(device):
    """``chip_smoke.py`` phase 4e's equalities at 2,000 rows and 3 rounds:
    the chaos twin == the fault-free run; the party-dropout run == the
    masked ``local-cuda`` run; the gradient-less fallback launches once a
    party a level and its ledger is exact; the 2-shard run launches once a
    level for every (party, shard) block and equals the same run on CPU
    tensors."""
    from repro_torch.core import backend as backend_mod
    from repro_torch.core import boosting, forest, prng
    from repro_torch.data import synthetic, tabular
    from repro_torch.federation import chaos, compress, gradientless, runtime
    from repro_torch.kernels.histogram import ops

    parties = 4
    ds = synthetic.load("default_credit_card", n=2000)
    x, d = tabular.pad_features(np.asarray(ds.x_train), parties)
    cfg = boosting.dynamic_fedgbf_config(rounds=3)
    levels = cfg.tree.max_depth * cfg.rounds
    masks = forest.draw_step_masks(cfg, x.shape[0], d,
                                   prng.PRNGKey(0, device))

    def train(name, dev=device, **kw):
        bk = kw.pop("backend", None) or backend_mod.get_backend(
            name, tree=cfg.tree, num_parties=parties, **kw.pop("bk", {}))
        ops.reset_launches()
        model, hist = boosting.train_fedgbf(x, ds.y_train, cfg, masks=masks,
                                            backend=bk, device=dev, **kw)
        if dev == device:
            torch.cuda.synchronize()
        return model, hist, ops.kernel_launches("histogram_round")

    def same(a, b):
        (ma, ha, _), (mb, hb, _) = a, b
        return (all(torch.equal(getattr(fa, f).cpu(), getattr(fb, f).cpu())
                    for fa, fb in zip(ma.forests, mb.forests)
                    for f in ("feature", "threshold", "gain", "leaf_weight"))
                and np.array_equal(ha.final_margin, hb.final_margin))

    base = train("vfl-histogram")
    faulty = train("vfl-histogram-chaos", bk={"chaos": chaos.ChaosSpec(
        drop=0.3, corrupt=0.2, dup=0.2, seed=3)})
    assert faulty[2] == levels and same(faulty, base)

    sched = runtime.dropout_schedule(0.4, cfg.rounds, parties, seed=2,
                                     policy=runtime.RetryPolicy(
                                         max_retries=0))
    rmask = runtime.degradation_masks(sched.degraded, d, parties)
    assert rmask is not None and not rmask.all()
    assert same(train("vfl-histogram", round_feature_mask=rmask),
                train(None, backend="local-cuda", round_feature_mask=rmask))

    meter = compress.MessageMeter()
    ops.reset_launches()
    _, info = gradientless.train_gradientless(
        x, ds.y_train, cfg, prng.PRNGKey(1000), parties, meter=meter,
        device=device)
    assert ops.kernel_launches("histogram_round") == parties * levels
    want = gradientless.wire_cost(x.shape[0], info["tree_counts"])
    assert meter.phase_totals() == {k: v for k, v in want.items()
                                    if v and k != "total"}

    sharded = train("vfl-histogram-sharded", bk={"data_shards": 2})
    assert sharded[2] == levels
    assert same(sharded, train("vfl-histogram-sharded", dev="cpu",
                               bk={"data_shards": 2}))
