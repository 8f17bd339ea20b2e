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
                    generator: torch.Generator) -> StepMasks:
    """Every scheduled build's masks, up front: the native sampler.  Round
    m's trees keep ``sample_keep_count(n, rho_id(m))`` rows and
    ``feature_keep_count(d, rho_feat)`` features each."""
    if cfg.sampling != "uniform":
        raise NotImplementedError(
            f"sampling={cfg.sampling!r} is not ported: GOSS draws its masks "
            "inside each round from that round's gradients")
    d_keep = feature_keep_count(d, cfg.rho_feat)
    smasks, fmasks = [], []
    for m in range(1, cfg.rounds + 1):
        s, f = sample_masks(
            generator, n, d, dynamic.n_trees_schedule(cfg, m),
            sample_keep_count(n, dynamic.rho_id_schedule(cfg, m)), d_keep)
        smasks.append(s)
        fmasks.append(f)
    return StepMasks(torch.cat(smasks), torch.cat(fmasks))


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
