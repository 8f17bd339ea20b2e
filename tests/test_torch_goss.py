"""Port vs JAX package: GOSS (gradient-based one-side sampling) on the CPU.

The JAX package draws GOSS's uniforms and feature masks inside each round
from per-build keys; the port draws the same ones from the same keys up
front (``forest.GossDraws``, ``core/prng.py``), or takes them as an
input.  With them, the weight masks must equal ``goss_masks_from_keys``' bit for bit (K = 1 and 3,
tied uniforms and tied gradients included) and training must build the JAX
scan engine's trees and leaves exactly; margins are held at 1e-6 as in
``tests/test_torch_train.py``.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as j_boosting
from repro.core import forest as j_forest
from repro_torch.core import boosting as t_boosting
from repro_torch.core import dynamic as t_dynamic
from repro_torch.core import forest as t_forest
from repro_torch.core import prng
from repro_torch.core.types import TreeConfig as TTreeConfig
from repro_torch.data import synthetic as t_synthetic
from torch_parity import assert_trees_equal, jax_config, jax_goss_draws


def _coarse(uniform):
    """``jax.random.uniform`` rounded down to eighths: most draws tie."""
    def draw(key, shape, *args, **kw):
        return jnp.floor(uniform(key, shape, *args, **kw) * 8.0) / 8.0
    return draw


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("ties", [False, True])
def test_goss_weights_equal_jax(k, ties):
    """``goss_weights`` from the JAX draws == ``goss_masks_from_keys``:
    the top set by stable rank of |g| (L1 over K channels), the threshold
    rule that keeps every row at or below the n_rand-th smallest uniform,
    and the float32 amplification."""
    rng = np.random.default_rng(5 + k)
    n, d, n_trees = 257, 6, 4
    g = rng.normal(size=(n, k) if k > 1 else n).astype(np.float32)
    if ties:  # tied |g| (and zeros) across the top-set boundary
        g = np.round(g, 1).astype(np.float32)
        g[::9] = 0.0
    keys = j_forest.fold_in_keys(jax.random.PRNGKey(k), jnp.arange(n_trees))
    uniform = jax.random.uniform
    patch = mock.patch("jax.random.uniform", _coarse(uniform)) if ties \
        else mock.patch("jax.random.uniform", uniform)
    for rho_id in (0.1, 0.3, 0.9):
        n_top, n_rand = j_forest.goss_counts(n, rho_id, 0.5)
        assert t_forest.goss_counts(n, rho_id, 0.5) == (n_top, n_rand)
        with patch:
            want, fmask = j_forest.goss_masks_from_keys(
                keys, jnp.asarray(g), d, n_top, n_rand, 5)
            u = jax.vmap(lambda key: jax.random.uniform(
                jax.random.split(key)[0], (n,)))(keys)
        got = t_forest.goss_weights(torch.from_numpy(g),
                                    torch.from_numpy(np.array(u)),
                                    n_top, n_rand)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        n_kept = (got.numpy() > 1).sum(1)
        assert (n_kept >= n_rand).all()
        if ties:  # tied uniforms pull in more than n_rand random rows
            assert (n_kept > n_rand).any()


def _train_both(t_cfg, ds, backend):
    """Both packages from ``PRNGKey(0)`` alone."""
    j_cfg = jax_config(t_cfg)
    jm, jh = j_boosting.train_fedgbf(
        jnp.asarray(ds.x_train), jnp.asarray(ds.y_train), j_cfg,
        jax.random.PRNGKey(0))
    tm, th = t_boosting.train_fedgbf(
        ds.x_train, ds.y_train, t_cfg, prng.PRNGKey(0), backend=backend,
        device="cpu")
    return (jm, jh), (tm, th)


@pytest.mark.parametrize("loss,dataset", [
    ("logistic", "default_credit_card"), ("softmax3", "credit_risk_tiers")])
def test_goss_training_equals_jax_scan(loss, dataset):
    """GOSS training through ``local`` and through the CPU plain version
    of ``local-cuda``: trees, leaves and leaf assignment exact against the
    JAX scan engine (the histogram products ``g * w`` with fractional
    weights round once in both), margins within 1e-6, metrics 1e-5."""
    ds = t_synthetic.load(dataset, n=400)
    cfg = dataclasses.replace(
        t_boosting.dynamic_fedgbf_config(rounds=4, sampling="goss",
                                         loss=loss), rho_feat=0.8)
    for backend in ("local", "local-cuda"):
        (jm, jh), (tm, th) = _train_both(cfg, ds, backend)
        assert len(tm.forests) == len(jm.forests) == 4
        for tf, jf in zip(tm.forests, jm.forests):
            assert_trees_equal(tf, jf, leaf_atol=0)
        np.testing.assert_allclose(th.final_margin, jh.final_margin,
                                   rtol=0, atol=1e-6)
        for got, want in zip(th.train, jh.train):
            for key in want:
                assert abs(got[key] - want[key]) <= 1e-5, key


def test_goss_native_draws_and_invariants():
    """The key-based sampler: per build the JAX uniforms and exact-count
    feature masks (``jax_goss_draws``), deterministic per key; the weights
    of every round keep the n_top largest |g| at 1, the rest at 0
    or the amplification, with at least n_top + n_rand rows kept."""
    cfg = t_boosting.FedGBFConfig(rounds=5, n_trees_max=3, n_trees_min=2,
                                  rho_id_min=0.1, rho_id_max=0.3,
                                  rho_feat=0.6, sampling="goss")
    n, d = 600, 10
    draws = t_forest.draw_step_masks(cfg, n, d, prng.PRNGKey(3))
    assert isinstance(draws, t_forest.GossDraws)
    sched, _ = t_dynamic.flat_schedule(cfg)
    assert draws.uniform.shape == (int(sched.n_trees.sum()), n)
    assert draws.uniform.device.type == "cpu"
    assert ((draws.uniform >= 0) & (draws.uniform < 1)).all()
    assert (draws.feature.sum(1) == 6).all()
    again = t_forest.draw_step_masks(cfg, n, d, prng.PRNGKey(3))
    assert torch.equal(again.uniform, draws.uniform)
    uniform, feature = jax_goss_draws(jax_config(cfg), n, d, seed=3)
    np.testing.assert_array_equal(draws.uniform.numpy(), uniform)
    np.testing.assert_array_equal(draws.feature.numpy(), feature)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=n)
                         .astype(np.float32))
    for m in range(1, cfg.rounds + 1):
        n_top, n_rand = t_forest.goss_counts(
            n, t_dynamic.rho_id_schedule(cfg, m), cfg.goss_top_share)
        w = t_forest.goss_weights(g, draws.uniform[:3], n_top, n_rand)
        top = torch.argsort(-g.abs(), stable=True)[:n_top]
        amplify = np.float32(n - n_top) / np.float32(n_rand)
        assert (w[:, top] == 1).all()
        assert set(w.unique().tolist()) <= {0.0, 1.0, float(amplify)}
        assert ((w != 0).sum(1) >= n_top + n_rand).all()


def test_goss_plan_keeps_shared_root_off():
    """Under GOSS the segment plan never takes the shared-root path, as
    the JAX plan (``boosting.py:472``)."""
    cfg = t_boosting.FedGBFConfig(
        rounds=5, n_trees_max=3, n_trees_min=2, rho_id_min=0.6,
        rho_id_max=0.8, tree=TTreeConfig(shared_root=True), sampling="goss")
    plan = t_boosting._plan_segments(cfg, 500)
    assert plan == j_boosting._plan_segments(jax_config(cfg), 500)
    assert all(p[3] == 0 for p in plan)
    uniform = dataclasses.replace(cfg, sampling="uniform")
    assert any(p[3] for p in t_boosting._plan_segments(uniform, 500))
    for start, stop in ((1, 4), (2, 3), (0, 5)):
        assert t_boosting._plan_segments(uniform, 500, start, stop) == \
            j_boosting._plan_segments(jax_config(uniform), 500, start, stop)
