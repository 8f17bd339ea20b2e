"""The benchmark's data, made from the run's seed: a frozen copy of the
port's ``data/synthetic.py`` generator (``_credit_like``, ``_split``,
``give_me_some_credit``, ``default_credit_card``) in numpy, kept here so
that a change to the program cannot change the yardstick.

The public sets (Kaggle's Give Me Some Credit, UCI's Default of Credit
Card Clients) cannot be downloaded where the benchmark runs, so the data
is synthetic with their shapes, class imbalance and signal structure.
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


def _credit_like(rng: np.random.Generator, n: int, d: int, pos_rate: float,
                 interaction_pairs: int) -> tuple[np.ndarray, np.ndarray]:
    # heavy-tailed monetary features, bounded utilisation ratios, counts
    n_heavy = d // 3
    n_ratio = d // 3
    n_count = d - n_heavy - n_ratio
    heavy = rng.lognormal(mean=0.0, sigma=1.2, size=(n, n_heavy))
    ratio = rng.beta(2.0, 5.0, size=(n, n_ratio))
    count = rng.poisson(lam=3.0, size=(n, n_count)).astype(np.float64)
    x = np.concatenate([heavy, ratio, count], axis=1)
    # missing-value spikes: 5% of the heavy features at a sentinel
    miss = rng.random((n, n_heavy)) < 0.05
    x[:, :n_heavy][miss] = -1.0
    # sparse logit with pairwise interactions and a non-monotone term
    z = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-9)
    w = rng.normal(size=d) * (rng.random(d) < 0.7)
    logit = z @ w * 0.8
    for _ in range(interaction_pairs):
        i, j = rng.integers(0, d, size=2)
        logit += 0.5 * z[:, i] * z[:, j]
    k = rng.integers(0, d)
    logit += 0.6 * np.abs(z[:, k]) - 0.5
    logit += rng.normal(scale=0.8, size=n)
    # the intercept calibrated to the target positive rate
    thresh = np.sort(logit)[int((1.0 - pos_rate) * n)]
    y = (logit > thresh).astype(np.float32)
    return x.astype(np.float32), y


def _split(x, y, rng, train_frac=0.7):
    """Train and test divided 7:3 (the paper's section 4.1)."""
    n = x.shape[0]
    perm = rng.permutation(n)
    k = int(train_frac * n)
    tr, te = perm[:k], perm[k:]
    return x[tr], y[tr], x[te], y[te]


def give_me_some_credit(seed: int, n: int = 150_000) -> Dataset:
    """150,000 x 10, about 6.7% positives."""
    rng = np.random.default_rng(seed)
    x, y = _credit_like(rng, n, 10, pos_rate=0.067, interaction_pairs=3)
    return Dataset(*_split(x, y, rng), "give_me_some_credit")


def default_credit_card(seed: int, n: int = 30_000) -> Dataset:
    """30,000 x 23, about 22% positives."""
    rng = np.random.default_rng(seed)
    x, y = _credit_like(rng, n, 23, pos_rate=0.22, interaction_pairs=5)
    return Dataset(*_split(x, y, rng), "default_credit_card")


GENERATORS = {
    "give_me_some_credit": give_me_some_credit,
    "default_credit_card": default_credit_card,
}


def seed_words(seed: int) -> int:
    """The seed as numpy takes it: any whole number, folded to 64 bits."""
    return int(seed) % (1 << 64)


def make(spec: dict, seed: int) -> Dataset:
    """The dataset a configuration names (``spec``: ``generator`` and
    ``n``), drawn from ``seed``."""
    return GENERATORS[spec["generator"]](seed_words(seed), n=int(spec["n"]))


def training_rows(ds: Dataset, rows: str) -> tuple[np.ndarray, np.ndarray]:
    """``"train"``: the 7:3 split's training rows; ``"all"``: train and
    test together, as the production grid uses them."""
    if rows == "train":
        return ds.x_train, ds.y_train
    if rows == "all":
        return (np.concatenate([ds.x_train, ds.x_test]),
                np.concatenate([ds.y_train, ds.y_test]))
    raise ValueError(f"rows must be 'train' or 'all', got {rows!r}")


def pad_columns(x: np.ndarray, parties: int) -> np.ndarray:
    """Constant zero columns on the right until the parties split the
    columns evenly (a constant column never splits)."""
    rem = (-x.shape[1]) % parties
    if rem == 0:
        return x
    return np.concatenate([x, np.zeros((x.shape[0], rem), x.dtype)], axis=1)
