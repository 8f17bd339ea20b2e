"""Port vs JAX package: gradient-less party-local training on the CPU
(``selftest.check_gradientless``'s cases: K = 1 with 4 parties, K = 3 with
2).

Each party's fit draws its masks from ``fold_in(PRNGKey(0), p)``, as the
JAX package does.  Held: every per-party tree array exact (features, thresholds,
gains, leaves, bin edges), the learned rates within rtol 1e-5 of JAX's
(Adam over 300 float32 steps on ``jax.grad`` vs ``torch.autograd``: the
reductions differ in the last ulp; ROADMAP §3 logs the measured gap), and
the margin/rate ledger equal to ``wire_cost`` and to the JAX meter
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.federation import compress as j_compress
from repro.federation import gradientless as j_gradientless
from repro_torch.core import prng
from repro_torch.core.types import FedGBFConfig, TreeConfig
from repro_torch.federation import compress as t_compress
from repro_torch.federation import gradientless as t_gradientless
from repro_torch.federation import selftest as t_selftest
from torch_parity import jax_config

SCALE_RTOL = 1e-5


def _case(parties, loss, n=600):
    """``check_gradientless``'s data: 3 columns a party, rng 23."""
    rng = np.random.default_rng(23)
    d = parties * 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    logit = x[:, 0] - 0.8 * x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    if loss.startswith("softmax"):
        cuts = np.quantile(logit, np.linspace(0, 1, 4)[1:-1])
        y = np.searchsorted(cuts, logit).astype(np.float32)
    else:
        y = (logit + rng.normal(0, 0.7, n) > 0).astype(np.float32)
    cfg = FedGBFConfig(rounds=3, n_trees_max=3, n_trees_min=2,
                       rho_id_min=0.5, rho_id_max=0.8, loss=loss,
                       tree=TreeConfig(max_depth=3, num_bins=16))
    return x, y, cfg


@pytest.mark.parametrize("parties,loss", [(4, "logistic"), (2, "softmax3")])
def test_gradientless_equals_jax(parties, loss):
    x, y, cfg = _case(parties, loss)
    n, d = x.shape
    j_cfg = jax_config(cfg)
    key = jax.random.PRNGKey(0)
    j_meter = j_compress.MessageMeter()
    j_packed, j_info = j_gradientless.train_gradientless(
        jnp.asarray(x), jnp.asarray(y), j_cfg, key, parties, meter=j_meter)
    meter = t_compress.MessageMeter()
    packed, info = t_gradientless.train_gradientless(
        x, y, cfg, prng.PRNGKey(0), parties, meter=meter, device="cpu")

    for f in ("feature", "threshold", "gain", "leaf_weight", "bin_edges"):
        np.testing.assert_array_equal(getattr(packed, f).numpy(),
                                      np.asarray(getattr(j_packed, f)), f)
    np.testing.assert_allclose(packed.tree_scale.numpy(),
                               np.asarray(j_packed.tree_scale),
                               rtol=SCALE_RTOL, atol=0)
    assert packed.round_offsets == tuple(j_packed.round_offsets)
    assert packed.base_score == j_packed.base_score
    assert info["tree_counts"] == j_info["tree_counts"]
    assert info["n_channels"] == j_info["n_channels"]
    np.testing.assert_allclose(info["loss_before"], j_info["loss_before"],
                               rtol=1e-6)
    np.testing.assert_allclose(info["loss_after"], j_info["loss_after"],
                               rtol=1e-5)
    assert info["loss_after"] <= info["loss_before"] + 1e-6

    want = t_gradientless.wire_cost(n, info["tree_counts"],
                                    n_channels=info["n_channels"])
    assert want == j_gradientless.wire_cost(n, j_info["tree_counts"],
                                            n_channels=j_info["n_channels"])
    measured = meter.phase_totals()
    assert measured == j_meter.phase_totals()
    assert measured == {k: v for k, v in want.items()
                        if v and k != "total"}


def test_gradientless_native_draws():
    """The selftest's checks from its key, ``PRNGKey(0)`` — party-local
    trees, the rate fit no worse, the ledger exact — at K = 1."""
    info = t_selftest.check_gradientless(2, loss="logistic", n=300)
    assert len(info["tree_counts"]) == 2
