"""Synthetic stand-ins for the paper's benchmark datasets (§4.1).

A copy of the JAX package's ``repro/data/synthetic.py``:
the port imports no module of that package, so it keeps its own.

The Kaggle datasets are not available offline (repro band 2/5 — data gate),
so we generate credit-risk-like data with the *same shape, class imbalance and
signal structure*: a sparse-logit ground truth with feature interactions,
heavy-tailed monetary features and missing-value spikes, which is what makes
tree ensembles the right model family on the real datasets.

  give_me_some_credit : 150 000 x 10, ~6.7 % positive rate
  default_credit_card : 30 000 x 23, ~22 % positive rate

All relative claims (FedGBF vs SecureBoost quality/efficiency) are evaluated
on these; absolute AUCs are reported but not compared against the paper's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Dataset(NamedTuple):
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    name: str
    # Vertical split used by the paper (Table 1): active-party feature count.
    active_dims: int


def _credit_like(
    rng: np.random.Generator,
    n: int,
    d: int,
    pos_rate: float,
    interaction_pairs: int,
) -> tuple[np.ndarray, np.ndarray]:
    # Heavy-tailed monetary features + bounded utilisation ratios + counts.
    n_heavy = d // 3
    n_ratio = d // 3
    n_count = d - n_heavy - n_ratio

    heavy = rng.lognormal(mean=0.0, sigma=1.2, size=(n, n_heavy))
    ratio = rng.beta(2.0, 5.0, size=(n, n_ratio))
    count = rng.poisson(lam=3.0, size=(n, n_count)).astype(np.float64)
    x = np.concatenate([heavy, ratio, count], axis=1)

    # Missing-value spikes (credit bureaus): 5% of heavy features clamped to a
    # sentinel, which quantile binning must isolate into its own bin.
    miss = rng.random((n, n_heavy)) < 0.05
    x[:, :n_heavy][miss] = -1.0

    # Sparse logit with pairwise interactions and a non-monotone term.
    z = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-9)
    w = rng.normal(size=d) * (rng.random(d) < 0.7)
    logit = z @ w * 0.8
    for _ in range(interaction_pairs):
        i, j = rng.integers(0, d, size=2)
        logit += 0.5 * z[:, i] * z[:, j]
    k = rng.integers(0, d)
    logit += 0.6 * np.abs(z[:, k]) - 0.5
    logit += rng.normal(scale=0.8, size=n)

    # Calibrate the intercept to hit the target positive rate.
    logit_sorted = np.sort(logit)
    thresh = logit_sorted[int((1.0 - pos_rate) * n)]
    y = (logit > thresh).astype(np.float32)
    return x.astype(np.float32), y


def _split(x, y, rng, train_frac=0.7):
    """Paper §4.1: train/test divided 7:3."""
    n = x.shape[0]
    perm = rng.permutation(n)
    k = int(train_frac * n)
    tr, te = perm[:k], perm[k:]
    return x[tr], y[tr], x[te], y[te]


def give_me_some_credit(seed: int = 0, n: int = 150_000) -> Dataset:
    """150k x 10, ~6.7% positives, active party holds 5 of 10 dims (Table 1)."""
    rng = np.random.default_rng(seed)
    x, y = _credit_like(rng, n, 10, pos_rate=0.067, interaction_pairs=3)
    xt, yt, xe, ye = _split(x, y, rng)
    return Dataset(xt, yt, xe, ye, "give_me_some_credit", active_dims=5)


def default_credit_card(seed: int = 1, n: int = 30_000) -> Dataset:
    """30k x 23, ~22% positives, active party holds 13 of 23 dims (Table 1)."""
    rng = np.random.default_rng(seed)
    x, y = _credit_like(rng, n, 23, pos_rate=0.22, interaction_pairs=5)
    xt, yt, xe, ye = _split(x, y, rng)
    return Dataset(xt, yt, xe, ye, "default_credit_card", active_dims=13)


def credit_risk_tiers(seed: int = 2, n: int = 20_000) -> Dataset:
    """20k x 12, THREE risk tiers (low/watch/default) — multiclass workload.

    Same credit-like feature generator as the binary datasets; the latent
    logit is cut at its 60th/85th percentiles into ordinal tiers, so the
    class structure is feature-driven (not random labels) and imbalanced
    like real delinquency buckets (~60/25/15).  Labels are float class ids
    {0, 1, 2} for the ``softmax3`` objective (DESIGN.md §11).
    """
    rng = np.random.default_rng(seed)
    d = 12
    x, _ = _credit_like(rng, n, d, pos_rate=0.5, interaction_pairs=4)
    z = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-9)
    w = rng.normal(size=d) * (rng.random(d) < 0.7)
    logit = z @ w * 0.8
    for _ in range(4):
        i, j = rng.integers(0, d, size=2)
        logit += 0.5 * z[:, i] * z[:, j]
    logit += rng.normal(scale=0.6, size=n)
    lo, hi = np.quantile(logit, [0.60, 0.85])
    y = (logit > lo).astype(np.float32) + (logit > hi).astype(np.float32)
    xt, yt, xe, ye = _split(x, y, rng)
    return Dataset(xt, yt, xe, ye, "credit_risk_tiers", active_dims=6)


DATASETS = {
    "give_me_some_credit": give_me_some_credit,
    "default_credit_card": default_credit_card,
    "credit_risk_tiers": credit_risk_tiers,
}


def load(name: str, seed: int = 0, n: int | None = None) -> Dataset:
    fn = DATASETS[name]
    return fn(seed=seed) if n is None else fn(seed=seed, n=n)
