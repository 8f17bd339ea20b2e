"""Port vs JAX package: split gains, the per-node argmax and leaf weights
(CPU).

Feature and threshold must be exact.  Empty bins make plateaus of exactly
equal gains, where the threshold is the first maximal index — provided the
cumulative sums repeat exactly across the empty bins, as XLA's blocked
cumsum makes them do (also across its 16-bin block boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import split as j_split

# the JAX side jitted: one compile per shape instead of op-by-op dispatch
j_gains = jax.jit(j_split.split_gains, static_argnums=1)
j_choose = jax.jit(j_split.choose_splits, static_argnums=2)
j_choose_round = jax.jit(j_split.choose_splits_round, static_argnums=2)
from repro.core.types import TreeConfig as JTreeConfig
from repro_torch.core import split as t_split
from repro_torch.core.types import TreeConfig as TTreeConfig


def _hist(rng, lead, d, num_bins, k=1, empty_frac=0.3):
    """A histogram of integer counts, g/h sums consistent with them, and a
    share of empty bins."""
    shape = lead + (d, num_bins)
    count = rng.integers(0, 40, shape).astype(np.float32)
    count[rng.random(shape) < empty_frac] = 0
    g = (rng.normal(size=shape + (k,)) * count[..., None]).astype(np.float32)
    h = (rng.uniform(0.1, 0.25, shape + (k,))
         * count[..., None]).astype(np.float32)
    return np.concatenate([g, h, count[..., None]], axis=-1)


def _cfgs(**kw):
    return JTreeConfig(**kw), TTreeConfig(**kw)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("num_bins", [16, 32, 40])
def test_gains_and_splits_equal_jax(k, num_bins):
    rng = np.random.default_rng(num_bins + k)
    jc, tc = _cfgs(num_bins=num_bins, gamma=0.05, min_child_weight=0.5)
    hist = _hist(rng, (3, 4), 6, num_bins, k)           # (T, nodes, d, B, S)
    fmask = rng.random((3, 6)) < 0.7
    np.testing.assert_array_equal(
        t_split.split_gains(torch.from_numpy(hist), tc).numpy(),
        np.stack([np.asarray(j_gains(jnp.asarray(ht), jc))
                  for ht in hist]))
    got = t_split.choose_splits_round(torch.from_numpy(hist),
                                      torch.from_numpy(fmask), tc)
    want = j_choose_round(jnp.asarray(hist), jnp.asarray(fmask), jc)
    for field in ("feature", "threshold", "gain"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    one = t_split.choose_splits(torch.from_numpy(hist[1]),
                                torch.from_numpy(fmask[1]), tc,
                                feature_offset=10)
    np.testing.assert_array_equal(one.feature.numpy(),
                                  np.where(got.feature[1].numpy() >= 0,
                                           got.feature[1].numpy() + 10, -1))


@pytest.mark.parametrize("num_bins,empty", [(16, (3, 7)), (32, (13, 19))],
                         ids=["inside-a-block", "across-the-16-boundary"])
def test_empty_bin_plateau(num_bins, empty):
    """One feature's best split sits on a run of empty bins: every
    threshold across them has the same gain, and the first one wins."""
    rng = np.random.default_rng(7)
    jc, tc = _cfgs(num_bins=num_bins)
    hist = _hist(rng, (2,), 3, num_bins, empty_frac=0.0)
    lo, hi = empty
    hist[:, 1, :, 1:] = np.maximum(hist[:, 1, :, 1:], [0.2, 1.0])  # no gap
    hist[:, 1, lo:hi] = 0.0
    # gradients -5 per row left of the run and +5 right of it: the best
    # split separates the two, anywhere on the run
    hist[:, 1, :lo, 0] = -5 * hist[:, 1, :lo, 2]
    hist[:, 1, hi:, 0] = 5 * hist[:, 1, hi:, 2]
    fmask = np.ones(3, bool)
    gains = t_split.split_gains(torch.from_numpy(hist), tc).numpy()
    plateau = gains[:, 1, lo - 1:hi]
    assert (plateau == plateau[:, :1]).all()              # exactly equal
    got = t_split.choose_splits(torch.from_numpy(hist),
                                torch.from_numpy(fmask), tc)
    want = j_choose(jnp.asarray(hist), jnp.asarray(fmask), jc)
    np.testing.assert_array_equal(got.feature.numpy(), [1, 1])
    np.testing.assert_array_equal(got.threshold.numpy(), [lo - 1, lo - 1])
    np.testing.assert_array_equal(got.threshold.numpy(),
                                  np.asarray(want.threshold))
    np.testing.assert_array_equal(got.gain.numpy(), np.asarray(want.gain))


def test_no_split_and_masked_features():
    jc, tc = _cfgs(num_bins=16, gamma=1e9)               # nothing pays off
    hist = _hist(np.random.default_rng(3), (4,), 5, 16)
    got = t_split.choose_splits(torch.from_numpy(hist),
                                torch.ones(5, dtype=torch.bool), tc)
    np.testing.assert_array_equal(got.feature.numpy(), [-1] * 4)
    np.testing.assert_array_equal(got.threshold.numpy(), [16] * 4)
    jc, tc = _cfgs(num_bins=16)
    got = t_split.choose_splits(torch.from_numpy(hist),
                                torch.zeros(5, dtype=torch.bool), tc)
    want = j_choose(jnp.asarray(hist), jnp.zeros(5, bool), jc)
    np.testing.assert_array_equal(got.feature.numpy(), [-1] * 4)
    np.testing.assert_array_equal(got.gain.numpy(), np.asarray(want.gain))


@pytest.mark.parametrize("k", [1, 3])
def test_leaf_weights_equal_jax(k):
    rng = np.random.default_rng(k)
    leaf = _hist(rng, (3,), 8, 1, k)[:, :, 0, :]          # (T, L, 2K+1)
    jc, tc = _cfgs(lambda_=0.7)
    np.testing.assert_array_equal(
        t_split.leaf_weights(torch.from_numpy(leaf), tc).numpy(),
        np.stack([np.asarray(j_split.leaf_weights(jnp.asarray(lt), jc))
                  for lt in leaf]))
