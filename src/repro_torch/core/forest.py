"""Random-forest layer: the bagging base learner of FedGBF (Alg. 1 lines
3-7) — the counterpart of ``repro/core/forest.py``.

The N trees of a round share (g, h) and differ only in their sampling
masks P_m(j), Q_m(j) (eq. 4).  The JAX package draws those masks with
``jax.random.permutation`` under threefry, which torch cannot reproduce, so
masks are an explicit input here: ``StepMasks`` holds one (sample,
feature) pair per scheduled tree build.  A run that must match the JAX
package takes the masks the JAX package drew (``convert.masks_from_numpy``);
otherwise ``draw_step_masks`` draws them natively from an explicit
``torch.Generator``, with the JAX package's exact keep-counts but not its
draws.

GOSS (``sampling="goss"``) weighs the rows of each round from that round's
gradients, so its masks cannot be drawn up front.  Its random inputs can:
``GossDraws`` holds one uniform vector (n,) and one feature mask per
scheduled build (the JAX package's ``jax.random.uniform`` and permutation
of the same per-slot key; ``convert.goss_draws_from_numpy``), and
``goss_weights`` turns a round's gradients and draws into the weight masks
exactly as ``goss_masks_from_keys`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import dynamic
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


def sample_masks(generator: torch.Generator, n: int, d: int, n_trees: int,
                 n_keep: int, d_keep: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Exact-count masks for ``n_trees`` trees: ``randperm(n) < n_keep``
    places exactly ``n_keep`` ones uniformly at random (and ``d_keep`` for
    the features).  Drawn on the CPU from ``generator``.

    Returns:
      sample_mask (n_trees, n) float32 in {0, 1}, feature_mask (n_trees, d)
      bool.
    """
    smask = torch.stack([torch.randperm(n, generator=generator) < n_keep
                         for _ in range(n_trees)]).to(torch.float32)
    fmask = torch.stack([torch.randperm(d, generator=generator) < d_keep
                         for _ in range(n_trees)])
    return smask, fmask


def draw_step_masks(cfg, n: int, d: int,
                    generator: torch.Generator) -> StepMasks | GossDraws:
    """Every scheduled build's masks (GOSS: its draws), up front, on the
    CPU: the native sampler.  Round m's trees keep ``sample_keep_count(n,
    rho_id(m))`` rows and ``feature_keep_count(d, rho_feat)`` features
    each; under GOSS each build draws ``torch.rand(n)`` and then its
    feature mask."""
    if cfg.sampling == "goss":
        return draw_goss_draws(cfg, n, d, generator)
    d_keep = feature_keep_count(d, cfg.rho_feat)
    smasks, fmasks = [], []
    for m in range(1, cfg.rounds + 1):
        s, f = sample_masks(
            generator, n, d, dynamic.n_trees_schedule(cfg, m),
            sample_keep_count(n, dynamic.rho_id_schedule(cfg, m)), d_keep)
        smasks.append(s)
        fmasks.append(f)
    return StepMasks(torch.cat(smasks), torch.cat(fmasks))


def draw_goss_draws(cfg, n: int, d: int,
                    generator: torch.Generator) -> GossDraws:
    """GOSS's draws for every scheduled build, from ``generator`` on the
    CPU (so a run on the card and one on the CPU see the same draws)."""
    d_keep = feature_keep_count(d, cfg.rho_feat)
    n_steps = sum(dynamic.n_trees_schedule(cfg, m)
                  for m in range(1, cfg.rounds + 1))
    uniform, feature = [], []
    for _ in range(n_steps):
        uniform.append(torch.rand(n, generator=generator))
        feature.append(torch.randperm(d, generator=generator) < d_keep)
    return GossDraws(torch.stack(uniform), torch.stack(feature))


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
