"""The seeded draws of a FedGBF job, worked out again in numpy: a frozen
copy of the threefry-2x32 key chain and mask draw that the program takes
from ``jax.random`` (default PRNG, partitionable counters), and of the
Dynamic FedGBF schedules (the paper's eqs. 6-7, section 3.2.2).

Keys are ``(..., 2)`` uint64 arrays holding two uint32 words.  Every add
is masked to 32 bits.
"""

from __future__ import annotations

import math

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint64(0x1BD11BDA)


def prng_key(seed: int) -> np.ndarray:
    """``PRNGKey(seed)`` without 64-bit mode: the seed's low 32 bits."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint64)


def _rotl(v, r):
    return ((v << np.uint64(r)) & _M32) | (v >> np.uint64(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds; all arguments broadcast uint64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return x0, x1


def _hash(keys: np.ndarray, n: int):
    idx = np.arange(n, dtype=np.uint64)
    k0 = keys[..., 0][..., None]
    k1 = keys[..., 1][..., None]
    return threefry2x32(k0, k1, idx >> np.uint64(32), idx & _M32)


def split(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """``split``: ``(..., num, 2)``."""
    b0, b1 = _hash(keys, num)
    return np.stack([b0, b1], axis=-1)


def fold_in(keys: np.ndarray, data) -> np.ndarray:
    """``fold_in``: the key's hash of the counter words ``(0, data)``."""
    data = np.asarray(data, np.uint64) & _M32
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], np.zeros_like(data),
                          data)
    return np.stack([b0, b1], axis=-1)


def permutation(keys: np.ndarray, n: int) -> np.ndarray:
    """``permutation(key, n)`` for a batch of keys: rounds of a stable sort
    of ``arange(n)`` by fresh 32-bit draws."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = np.broadcast_to(np.arange(n, dtype=np.int64),
                        keys.shape[:-1] + (n,)).copy()
    for _ in range(rounds):
        pair = split(keys)
        keys, sub = pair[..., 0, :], pair[..., 1, :]
        b0, b1 = _hash(sub, n)
        order = np.argsort(b0 ^ b1, axis=-1, kind="stable")
        x = np.take_along_axis(x, order, axis=-1)
    return x


def _decay(t, total, lo, hi, k):
    if total <= 1:
        return hi
    horizon = k * (total - 1)
    if t > horizon + 1:
        return lo
    return lo + (hi - lo) * math.cos(math.pi * (t - 1) / (2.0 * horizon))


def _increase(t, total, lo, hi, k):
    if total <= 1:
        return hi
    horizon = k * (total - 1)
    if t > horizon + 1:
        return hi
    return lo + (hi - lo) * math.sin(math.pi * (t - 1) / (2.0 * horizon))


def trees_per_round(model: dict) -> list:
    """Trees of each round: a cosine decay from ``n_trees_max`` to
    ``n_trees_min``, rounded."""
    r = model["rounds"]
    return [max(1, int(round(_decay(m, r, float(model["n_trees_min"]),
                                    float(model["n_trees_max"]),
                                    model["n_trees_speed"]))))
            for m in range(1, r + 1)]


def rho_per_round(model: dict) -> list:
    """Sample rate of each round: a sine increase from ``rho_id_min`` to
    ``rho_id_max``."""
    r = model["rounds"]
    return [float(_increase(m, r, model["rho_id_min"], model["rho_id_max"],
                            model["rho_id_speed"]))
            for m in range(1, r + 1)]


def keep_count(n: int, rate: float) -> int:
    return max(1, int(round(n * rate)))


def step_masks(model: dict, n: int, d: int, seed: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Every tree's sample mask (S, n) bool and feature mask (S, d) bool,
    round by round and tree by tree: one split of the run key a round,
    ``fold_in(round key, slot)`` a tree, that key split into a sample and a
    feature key, and ``permutation(key, n) < keep`` placing exactly
    ``keep`` rows (and columns): uniform sampling, the only kind drawn
    here."""
    if model.get("sampling", "uniform") != "uniform":
        raise ValueError(f"no draw of {model['sampling']!r} sampling here")
    key = prng_key(seed)
    round_keys = []
    for _ in range(model["rounds"]):
        pair = split(key)
        key = pair[0]
        round_keys.append(pair[1])
    trees = trees_per_round(model)
    rounds = np.repeat(np.arange(len(trees)), trees)
    slots = np.concatenate([np.arange(t) for t in trees])
    keys = fold_in(np.stack(round_keys)[rounds], slots)
    pair = split(keys)
    n_keep = np.array([keep_count(n, r) for r in rho_per_round(model)])[rounds]
    d_keep = keep_count(d, model["rho_feat"])
    sample = permutation(pair[..., 0, :], n) < n_keep[:, None]
    feature = permutation(pair[..., 1, :], d) < d_keep
    return sample, feature
