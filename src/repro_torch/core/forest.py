"""Random-forest layer: the bagging base learner of FedGBF (Alg. 1 lines
3-7) — the counterpart of ``repro/core/forest.py``.

The N trees of a round share (g, h) and differ only in their sampling
masks P_m(j), Q_m(j) (eq. 4).  They are drawn as the JAX package draws
them, from the same keys (``core/prng.py``, its ``jax.random``): each
tree slot's key is ``fold_in(round_key, slot)``, split into a sample key
and a feature key, and ``permutation(key, n) < n_keep`` places exactly
``n_keep`` ones.  ``StepMasks`` holds one (sample, feature) pair per
scheduled tree build; ``draw_step_masks`` draws all of a run's in one
batched call, from the key chain the JAX scan engine derives
(``step_keys``).  An explicit ``StepMasks`` (e.g. ``convert.masks_from_numpy``)
overrides the draw.

GOSS (``sampling="goss"``) weighs the rows of each round from that round's
gradients, so its masks cannot be drawn up front.  Its random inputs can:
``GossDraws`` holds one uniform vector (n,) and one feature mask per
scheduled build (``uniform`` and ``permutation`` of the same per-slot
key), and ``goss_weights`` turns a round's gradients and draws into the
weight masks exactly as ``goss_masks_from_keys`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import dynamic, prng
from repro_torch.core import tree as tree_mod
from repro_torch.core.types import TreeArrays, TreeConfig


class StepMasks(NamedTuple):
    """One mask pair per scheduled tree build, in the order the engine
    builds them (``dynamic.flat_schedule``): round by round, slot by slot."""

    sample: torch.Tensor   # (S, n) float32 in {0, 1}
    feature: torch.Tensor  # (S, d) bool


class GossDraws(NamedTuple):
    """GOSS's random inputs, one row per scheduled tree build in build
    order: the uniforms that pick the random rows and the feature masks
    (the uniform path's masks for the same keys)."""

    uniform: torch.Tensor  # (S, n) float32 in [0, 1)
    feature: torch.Tensor  # (S, d) bool


def feature_keep_count(d: int, rho_feat: float) -> int:
    """The one rounding rule for d_m(j) = d * rho_feat (eq. 4)."""
    return max(1, int(round(d * rho_feat)))


def sample_keep_count(n: int, rho_id: float) -> int:
    """The one rounding rule for n_m(j) = n * rho_id (eq. 4), on the host
    in float64 as the JAX package rounds it."""
    return max(1, int(round(n * rho_id)))


def fold_in_keys(rng: torch.Tensor, indices) -> torch.Tensor:
    """Per-tree keys ``fold_in(rng, t)`` for every ``t`` in ``indices``:
    (K, 2).  Prefix-stable in the tree count, so any subset of slots draws
    exactly the masks a full round draws."""
    return prng.fold_in(rng, torch.as_tensor(indices, device=rng.device))


def masks_from_keys(keys: torch.Tensor, n: int, d: int, n_keep,
                    d_keep: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-count masks from per-tree keys (K, 2), in one batched draw:
    each key splits into a sample and a feature key, and
    ``permutation(key, n) < n_keep`` places exactly ``n_keep`` ones.
    ``n_keep`` is an int or a (K,) vector.

    Returns:
      sample_mask (K, n) float32 in {0, 1}, feature_mask (K, d) bool.
    """
    ks, kf = _split_pair(keys)
    n_keep = torch.as_tensor(n_keep, device=keys.device).reshape(-1, 1)
    smask = (prng.permutation(ks, n) < n_keep).to(torch.float32)
    fmask = prng.permutation(kf, d) < d_keep
    return smask, fmask


def _split_pair(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    pair = prng.split(keys)
    return pair[..., 0, :], pair[..., 1, :]


def sample_masks_counts(rng: torch.Tensor, n: int, d: int, n_trees: int,
                        n_keep, d_keep: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``sample_masks`` with explicit keep-counts."""
    return masks_from_keys(fold_in_keys(rng, torch.arange(n_trees)), n, d,
                           n_keep, d_keep)


def sample_masks(rng: torch.Tensor, n: int, d: int, n_trees: int,
                 rho_id: float, rho_feat: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-count subsampling masks of one round's ``n_trees`` trees from
    the round key ``rng``: ``n * rho_id`` rows and ``d * rho_feat``
    features each, without replacement (eq. 4)."""
    return sample_masks_counts(rng, n, d, n_trees,
                               sample_keep_count(n, rho_id),
                               feature_keep_count(d, rho_feat))


def step_keys(rng: torch.Tensor, cfg) -> torch.Tensor:
    """Every scheduled build's key, (S, 2), in build order, as the JAX scan
    engine derives them (``repro/core/boosting.py:577-590``): one split of
    ``rng`` a round (the loop's stream, so round m's key is the same in a
    window that starts later), then ``fold_in(round_key, slot)``.  The
    chain runs on the CPU (20 tiny splits); the keys then go to ``rng``'s
    device."""
    key = rng.cpu()
    round_keys = []
    for _ in range(cfg.rounds):
        pair = prng.split(key)
        key = pair[0]
        round_keys.append(pair[1])
    _, flat = dynamic.flat_schedule(cfg)
    keys = prng.fold_in(torch.stack(round_keys)[
        torch.as_tensor(flat.round_of_step, dtype=torch.int64)],
        torch.as_tensor(flat.tree_in_round, dtype=torch.int64))
    return keys.to(rng.device)


def draw_step_masks(cfg, n: int, d: int,
                    rng: torch.Tensor) -> StepMasks | GossDraws:
    """Every scheduled build's masks (GOSS: its draws) from the run key
    ``rng`` (``step_keys``), in one batched draw on ``rng``'s device:
    round m's trees keep ``sample_keep_count(n, rho_id(m))`` rows and
    ``feature_keep_count(d, rho_feat)`` features each.  Equal to the JAX
    package's masks for the same key, and the same on the CPU and the
    card."""
    keys = step_keys(rng, cfg)
    d_keep = feature_keep_count(d, cfg.rho_feat)
    if cfg.sampling == "goss":
        return goss_draws_from_keys(keys, n, d, d_keep)
    _, flat = dynamic.flat_schedule(cfg)
    n_keep = torch.tensor([sample_keep_count(n, dynamic.rho_id_schedule(
        cfg, m)) for m in range(1, cfg.rounds + 1)], dtype=torch.int64)[
        torch.as_tensor(flat.round_of_step, dtype=torch.int64)]
    return StepMasks(*masks_from_keys(keys, n, d, n_keep.to(rng.device),
                                      d_keep))


def goss_draws_from_keys(keys: torch.Tensor, n: int, d: int,
                         d_keep: int) -> GossDraws:
    """GOSS's random inputs from per-tree keys: ``uniform(sample_key,
    (n,))`` and the uniform path's feature mask of the same key."""
    ks, kf = _split_pair(keys)
    return GossDraws(prng.uniform(ks, (n,)),
                     prng.permutation(kf, d) < d_keep)


def goss_counts(n: int, rho_id: float, top_share: float) -> tuple[int, int]:
    """Split the round's rho_id sample budget into GOSS (top, random) counts.

    ``n_keep = round(n * rho_id)`` samples total (the exact host expression
    the uniform path uses), of which ``round(n_keep * top_share)`` are the
    largest-|g| samples and the rest are drawn uniformly from the remainder.
    Clamped so at least one random sample is always drawn (the amplification
    factor divides by it) and the top set never swallows the whole dataset.
    """
    n_keep = max(1, min(n, int(round(n * rho_id))))
    n_top = max(0, min(int(round(n_keep * top_share)), n_keep - 1, n - 1))
    n_rand = max(1, min(n_keep - n_top, n - n_top))
    return n_top, n_rand


def goss_rank(g: torch.Tensor) -> torch.Tensor:
    """(n,) int64 rank of every row by descending |g| (K channels: the L1
    norm, summed left to right as XLA sums the small axis), ties toward the
    lower row: ``jnp.argsort`` is stable, and every zero is -0.0 here."""
    if g.dim() > 1:
        a = g.abs()
        g = a[:, 0]
        for k in range(1, a.shape[1]):
            g = g + a[:, k]
    order = torch.sort(-g.abs(), stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return rank


def goss_weights(g: torch.Tensor, uniform: torch.Tensor, n_top: int,
                 n_rand: int) -> torch.Tensor:
    """GOSS weight masks of one round's T trees, (T, n) float32 —
    ``goss_masks_from_keys``' sample masks, operation for operation.

    Each tree keeps the ``n_top`` largest-|g| rows at weight 1 and the rows
    whose uniform is at or below the ``n_rand``-th smallest uniform of the
    rest at weight ``(n - n_top) / n_rand`` (with tied uniforms that can be
    more than ``n_rand`` rows, as in the JAX rule).

    Args:
      g: (n,) or (n, K) gradients of the round.
      uniform: (T, n) float32 draws in [0, 1).
    """
    n = g.shape[0]
    is_top = (goss_rank(g) < n_top)[None, :]
    u = torch.where(is_top, torch.full_like(uniform, 2.0), uniform)
    thr = torch.sort(u, dim=1).values[:, min(max(n_rand - 1, 0), n - 1)]
    is_rand = ~is_top & (u <= thr[:, None])
    # the float32 quotient, as XLA forms it; a 0/1 mask times it is exact
    amplify = (torch.tensor(float(n - n_top), dtype=torch.float32)
               / torch.tensor(float(max(n_rand, 1)), dtype=torch.float32))
    return is_top.to(torch.float32) + is_rand.to(torch.float32) * float(
        amplify)


def goss_masks_from_keys(keys: torch.Tensor, g: torch.Tensor, d: int,
                         n_top: int, n_rand: int, d_keep: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """GOSS weight masks (K, n) and feature masks (K, d) from per-tree
    keys: the ``n_top`` largest-|g| rows at weight 1, ``n_rand`` of the
    rest by each key's uniforms at ``(n - n_top) / n_rand``
    (``goss_weights``)."""
    draws = goss_draws_from_keys(keys, g.shape[0], d, d_keep)
    return goss_weights(g, draws.uniform, n_top, n_rand), draws.feature


def goss_masks(rng: torch.Tensor, g: torch.Tensor, d: int, n_trees: int,
               n_top: int, n_rand: int, d_keep: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``goss_masks_from_keys`` over a round key."""
    return goss_masks_from_keys(fold_in_keys(rng, torch.arange(n_trees)),
                                g, d, n_top, n_rand, d_keep)


def build_forest_per_tree(binned: torch.Tensor, g: torch.Tensor,
                          h: torch.Tensor, sample_mask: torch.Tensor,
                          feature_mask: torch.Tensor, cfg: TreeConfig,
                          backend=None, root_delta_rows: int = 0
                          ) -> tuple[TreeArrays, torch.Tensor]:
    """Build all trees of one round; return (trees, per-tree predictions
    (T, n) or (T, n, K)) — the raw leaf outputs on the full training set,
    before any bagging combiner, which the training engine owns."""
    trees, assign = tree_mod.build_round(
        binned, g, h, sample_mask, feature_mask, cfg, backend=backend,
        root_delta_rows=root_delta_rows)
    index = assign.long()
    if trees.leaf_weight.dim() == 3:  # K-channel leaf table: (T, L, K)
        index = index[..., None].expand(-1, -1, trees.leaf_weight.shape[-1])
    return trees, torch.gather(trees.leaf_weight, 1, index)


def build_forest(binned, g, h, sample_mask, feature_mask, cfg: TreeConfig,
                 backend=None, root_delta_rows: int = 0):
    """Build all trees of one forest layer: (trees, train_pred) with
    ``train_pred`` (n,) the bagging mean on the full training set."""
    trees, per_tree = build_forest_per_tree(binned, g, h, sample_mask,
                                            feature_mask, cfg, backend,
                                            root_delta_rows)
    return trees, tree_mod._mean0(per_tree)
