"""The data axis (``-sharded``) on the CPU, held against the UNSHARDED
run — the port's and the JAX package's (its sharded reference fails under
the installed JAX's Explicit mesh axes, ROADMAP §3, so it is never the
oracle).

* the JAX selftest's sharded cases (2 shards; n 509 and 507, uneven;
  subtraction; softmax3; async): features and thresholds exact, leaves and
  predictions within rtol 1e-5 / atol 1e-6 (the selftest's tolerances) of
  the port's centralized build and of the JAX unsharded one on the same
  inputs; the shard partials are summed in shard order, not row order;
* the routing bitmap is metered per shard, ``S * ceil(ceil(n/S)/8)``
  bytes a level, and the whole ledger reconciles with the wire model at
  ``data_shards = S`` (and with the JAX wire model);
* every backend name of the JAX registry resolves in the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as j_backend
from repro.core import forest as j_forest
from repro.federation import protocol as j_protocol
from repro_torch.core import backend as t_backend
from repro_torch.core import binning, boosting
from repro_torch.core import objective as objective_mod
from repro_torch.core.types import FedGBFConfig, TreeConfig
from repro_torch.federation import compress as t_compress
from repro_torch.federation import protocol as t_protocol
from repro_torch.federation import selftest as t_selftest
from repro_torch.federation import vfl

RTOL, ATOL = 1e-5, 1e-6

#: the JAX selftest's sharded cases with 2 shards:
#: (parties, aggregation, kwargs)
CASES = {
    "p2-hist": (2, "histogram", {}),
    "p2-argmax": (2, "argmax", {}),
    "p2-hist-n509": (2, "histogram", dict(n=509)),
    "p4-hist-sub-n507": (4, "histogram", dict(subtraction=True, n=507)),
    "p2-hist-async-n509": (2, "histogram", dict(async_exchange=True, n=509)),
    "p2-softmax3-n509": (2, "histogram", dict(loss="softmax3", n=509)),
}


def _inputs(parties, n=512, loss="logistic", num_bins=16):
    """``selftest.check``'s inputs on the CPU."""
    rng = np.random.default_rng(0)
    obj = objective_mod.get_objective(loss)
    d = parties * 3
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, max(2, obj.n_classes), n)
                         .astype(np.float32))
    binned, _ = binning.fit_bin(x, num_bins)
    g, h = obj.grad_hess(y, obj.init_raw(n))
    smask, fmask = t_selftest._masks(7, n, d, 4, 0.8, 1.0, t_selftest.CPU)
    return binned, g, h, smask, fmask


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_unsharded(case):
    parties, aggregation, kw = CASES[case]
    kw = dict(kw)
    n, loss = kw.pop("n", 512), kw.pop("loss", "logistic")
    subtraction = kw.pop("subtraction", False)
    # the selftest's own check: against the port's centralized build
    t_selftest.check(parties, aggregation, True, data_shards=2, n=n,
                     loss=loss, subtraction=subtraction, **kw)
    cfg = TreeConfig(max_depth=3, num_bins=16, hist_subtraction=subtraction)
    binned, g, h, smask, fmask = _inputs(parties, n, loss)
    backend = vfl.make_vfl_backend(
        parties, cfg, aggregation=aggregation, shard_samples=True,
        data_shards=2, **kw)
    trees, pred = backend.build_forest(binned, g, h, smask, fmask, cfg)
    assert pred.shape[0] == n
    j_trees, j_pred = j_forest.build_forest(
        *(jnp.asarray(v.numpy()) for v in (binned, g, h, smask, fmask)),
        jax_tree(cfg))
    np.testing.assert_array_equal(trees.feature.numpy(),
                                  np.asarray(j_trees.feature))
    np.testing.assert_array_equal(trees.threshold.numpy(),
                                  np.asarray(j_trees.threshold))
    np.testing.assert_allclose(trees.leaf_weight.numpy(),
                               np.asarray(j_trees.leaf_weight), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_pred), rtol=RTOL,
                               atol=ATOL)


def jax_tree(cfg):
    from repro.core.types import TreeConfig as JTreeConfig

    return JTreeConfig(**dataclasses.asdict(cfg))


def test_sharded_training_and_one_histogram_call_a_level(monkeypatch):
    """End to end, 3 rounds on 509 rows: the sharded run's trees equal the
    unsharded run's, features and thresholds exact, margins at the
    tolerance; every level makes ONE histogram call (one kernel launch on
    the card) for all 4 x 3 (party, shard) blocks."""
    rng = np.random.default_rng(3)
    n, d = 509, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.normal(size=n) + x[:, 0] > 0).astype(np.float32)
    tree = TreeConfig(max_depth=3, num_bins=16)
    cfg = FedGBFConfig(rounds=3, n_trees_max=3, n_trees_min=2,
                       rho_id_min=0.5, rho_id_max=0.8, tree=tree)
    calls = []
    dispatch = vfl.histogram_dispatch

    def counting_dispatch(impl):
        base = dispatch(impl)

        def fn(binned, *args, **kw):
            calls.append(tuple(binned.shape))
            return base(binned, *args, **kw)
        return fn

    ref, ref_h = boosting.train_fedgbf(
        x, y, cfg, backend=t_backend.get_backend(
            "vfl-histogram", tree=tree, num_parties=4), device="cpu")
    monkeypatch.setattr(vfl, "histogram_dispatch", counting_dispatch)
    model, hist = boosting.train_fedgbf(
        x, y, cfg, backend=t_backend.get_backend(
            "vfl-histogram-sharded", tree=tree, num_parties=4,
            data_shards=3), device="cpu")
    # one call a level over the whole padded (n_pad, d) table
    assert calls == [(510, d)] * (tree.max_depth * cfg.rounds)
    for a, b in zip(model.forests, ref.forests):
        assert torch.equal(a.feature, b.feature)
        assert torch.equal(a.threshold, b.threshold)
        torch.testing.assert_close(a.leaf_weight, b.leaf_weight, rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(hist.final_margin, ref_h.final_margin,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shards,n", [(2, 1536), (2, 1531), (3, 1000),
                                      (4, 999)])
def test_id_partition_bytes_per_shard(shards, n):
    """``id_partition`` measures ``S * ceil(ceil(n/S)/8)`` bytes a level,
    and the ledger reconciles on every phase at ``data_shards = S``; the
    wire model equals the JAX package's."""
    tree = TreeConfig(max_depth=3, num_bins=32)
    per_tree, _ = t_compress.probe_tree_cost(
        4, tree, n_samples=n, num_features=8, data_shards=shards)
    m = -(-n // shards)
    assert per_tree["id_partition"] == tree.max_depth * shards * (
        (m + 7) // 8)
    cfg = FedGBFConfig(rounds=3, n_trees_max=4, n_trees_min=2,
                       rho_id_min=0.2, rho_id_max=0.5)
    ledger = t_compress.reconciled_ledger(4, tree, cfg, n_samples=n,
                                          num_features=8, data_shards=shards)
    assert ledger.matches(), ledger.reconcile()
    assert t_protocol.wire_party_tree_cost(n, 2, 32, 3, data_shards=shards) \
        == j_protocol.wire_party_tree_cost(n, 2, 32, 3, data_shards=shards)


def test_every_jax_registry_name_resolves():
    """The JAX registry's names — base, ``-sharded``, ``-chaos``,
    ``-sharded-chaos`` — are the port's, and each builds a backend of its
    name in the port."""
    jax_names = set(j_backend.available_backends())
    port_names = set(t_backend.available_backends())
    jax_vfl = {n for n in jax_names if n.startswith("vfl")}
    assert jax_vfl == {n for n in port_names if n.startswith("vfl")}
    assert len(jax_vfl) == 32
    tree = TreeConfig(max_depth=3, num_bins=16)
    for name in sorted(jax_vfl):
        bk = t_backend.get_backend(name, tree=tree, num_parties=2)
        assert bk.name == name
        assert bk.descriptor.shard_samples == ("-sharded" in name)
        assert (bk.descriptor.chaos is not None) == name.endswith("-chaos")
    for name in jax_names - jax_vfl:
        assert name.replace("pallas", "cuda") in port_names


def test_data_layout_refusals():
    tree = TreeConfig(max_depth=3, num_bins=16)
    with pytest.raises(ValueError, match="-sharded backend"):
        vfl.make_vfl_backend(2, tree, data_shards=2)
    with pytest.raises(ValueError, match=">= 1 data shard"):
        vfl.make_vfl_backend(2, tree, shard_samples=True, data_shards=0)
