"""Port vs JAX package: the objective registry's gradients, losses and
metric vectors, and the metrics module (CPU).

Tolerances: g and h are exact — the port computes ``exp`` as XLA's CPU
backend does (``objective.exp_xla``), so trees built from them can match
bit for bit.  Metric vectors, losses and reports use ``torch.exp`` and
reductions in torch's order: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as j_metrics
from repro.core import objective as j_objective
from repro_torch.core import losses as t_losses
from repro_torch.core import metrics as t_metrics
from repro_torch.core import objective as t_objective

OBJECTIVES = ("logistic", "squared", "quantile", "quantile@0.3", "softmax1",
              "softmax3")


def _inputs(name, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    k = t_objective.get_objective(name).n_classes
    if k > 1:
        y = rng.integers(0, k, n).astype(np.float32)
        margin = (rng.normal(size=(n, k)) * 3).astype(np.float32)
    elif name == "logistic" or name == "softmax1":
        y = (rng.random(n) < 0.3).astype(np.float32)
        margin = (rng.normal(size=n) * 4).astype(np.float32)
    else:
        y = rng.normal(size=n).astype(np.float32)
        margin = rng.normal(size=n).astype(np.float32)
    if k > 1:
        margin[0] = [0.0, 60.0, -60.0]
    else:
        margin[:3] = [0.0, 60.0, -60.0]  # sigmoid's flat tails
    return y, margin


def test_exp_xla_equals_jax_exp():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(size=50_000) * 4,
                        rng.uniform(-100, 100, 10_000),
                        [0.0, -0.0, 88.7, 88.8, 89.0, -87.4, -88.0, 1e-30,
                         -1e-30, np.inf, -np.inf]]).astype(np.float32)
    np.testing.assert_array_equal(
        t_objective.exp_xla(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jnp.exp)(x)))


@pytest.mark.parametrize("name", OBJECTIVES)
def test_grad_hess_bit_equal(name):
    y, margin = _inputs(name)
    jg, jh = jax.jit(j_objective.get_objective(name).grad_hess)(y, margin)
    tg, th = t_objective.get_objective(name).grad_hess(
        torch.from_numpy(y), torch.from_numpy(margin))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    tg2, _ = t_losses.grad_hess(name, torch.from_numpy(y),
                                torch.from_numpy(margin))
    np.testing.assert_array_equal(tg2.numpy(), tg.numpy())


@pytest.mark.parametrize("name", OBJECTIVES)
def test_metric_vector_and_loss(name):
    y, margin = _inputs(name, seed=2)
    jo, to = j_objective.get_objective(name), t_objective.get_objective(name)
    assert to.metric_keys == jo.metric_keys
    assert to.n_classes == jo.n_classes
    ty, tm = torch.from_numpy(y), torch.from_numpy(margin)
    np.testing.assert_allclose(to.metric_vector(ty, tm).numpy(),
                               np.asarray(jo.metric_vector(y, margin)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(t_losses.loss_value(name, ty, tm)),
                               float(jo.loss_value(y, margin)),
                               rtol=1e-5, atol=1e-5)
    got, want = to.evaluate(ty, tm), jo.evaluate(jnp.asarray(y), margin)
    assert got.keys() == want.keys()
    for key in got:
        assert abs(got[key] - want[key]) <= 1e-5, key
    init = to.init_raw(5, 0.25)
    np.testing.assert_array_equal(init.numpy(),
                                  np.asarray(jo.init_raw(5, 0.25)))


def test_auc_ties_and_reports():
    rng = np.random.default_rng(3)
    y = (rng.random(3000) < 0.25).astype(np.float32)
    score = rng.integers(0, 20, 3000).astype(np.float32)  # many ties
    np.testing.assert_allclose(
        float(t_metrics.auc(torch.from_numpy(y), torch.from_numpy(score))),
        float(j_metrics.auc(jnp.asarray(y), jnp.asarray(score))), atol=1e-6)
    margin = rng.normal(size=3000).astype(np.float32)
    got = t_metrics.classification_report(torch.from_numpy(y),
                                          torch.from_numpy(margin))
    want = j_metrics.classification_report(jnp.asarray(y),
                                           jnp.asarray(margin))
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-5, key
    labels = rng.integers(0, 3, 3000).astype(np.float32)
    m3 = rng.normal(size=(3000, 3)).astype(np.float32)
    got = t_metrics.multiclass_report(torch.from_numpy(labels),
                                      torch.from_numpy(m3))
    want = j_metrics.multiclass_report(jnp.asarray(labels), jnp.asarray(m3))
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-5, key


def test_registry_names_and_errors():
    assert (t_objective.available_objectives()
            == j_objective.available_objectives())
    assert t_objective.num_stats(3) == j_objective.num_stats(3) == 7
    for bad in ("softmax0", "softmaxx", "quantile@1.5", "quantilex", "nope"):
        with pytest.raises(ValueError):
            t_objective.get_objective(bad)
