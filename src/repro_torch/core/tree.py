"""Tree traversal and ensemble prediction: the prediction half of
``repro/core/tree.py``.

Every function keeps its JAX counterpart's order of floating-point
operations as written: each tree's ``scale * leaf`` is rounded, then added.
(XLA's CPU backend fuses that product and sum into one FMA, so on the CPU
the two packages' margins agree within 1e-6, not bit for bit; leaf routing
is identical.)  The tree axis that ``jax.vmap`` / ``lax.scan`` walked is a
Python loop here; the hand kernels in ``kernels/ensemble_predict`` replace
that loop on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import PackedEnsemble, TreeArrays, serving_tables


def _read_feature(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``x[row, f[row]]`` with ``f`` clamped into ``[0, d - 1]``: JAX clips
    ``f`` at 0 and its gather clamps the top, whereas a torch index of -1
    (an unsplit node) would read the last column."""
    col = f.clamp(0, x.shape[1] - 1).long()
    return x.gather(1, col.unsqueeze(1)).squeeze(1)


def traverse_level(x: torch.Tensor, idx: torch.Tensor,
                   feature: torch.Tensor, threshold: torch.Tensor
                   ) -> torch.Tensor:
    """One level of routing: each sample reads its node's (feature,
    threshold) and goes right iff its feature is strictly above the
    threshold; unsplit nodes (feature == -1) route every sample left.

    The one body serves both of the JAX package's traversals: int32 bins
    against bin-space thresholds (``traverse_level``), and raw floats
    against value-space thresholds (``traverse_level_values``,
    ``types.float_thresholds``), where NaN routes left (``NaN > t`` is
    False, the ``NAN_BIN`` semantics) and leaf routing equals binning
    followed by the binned traversal.

    Args:
      x: (n, d) int32 bins or float32 raw features.
      idx: (n,) int32 within-level node index.
      feature / threshold: (width,) — the level's nodes only.
    Returns:
      (n,) int32 next-level node index ``idx * 2 + go_right``.
    """
    node = idx.long()
    f = feature[node]
    t = threshold[node]
    go_right = (f >= 0) & (_read_feature(x, f) > t)
    return idx * 2 + go_right.to(torch.int32)


#: The JAX package's name for the raw-float traversal: the same body.
traverse_level_values = traverse_level


def leaf_index(x: torch.Tensor, feature: torch.Tensor,
               threshold: torch.Tensor, max_depth: int) -> torch.Tensor:
    """(n,) int32 leaf reached by each row of ``x`` in one tree."""
    idx = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    for level in range(max_depth):
        off, width = 2 ** level - 1, 2 ** level
        idx = traverse_level(x, idx, feature[off:off + width],
                             threshold[off:off + width])
    return idx


def predict_tree(tree: TreeArrays, binned: torch.Tensor,
                 max_depth: int) -> torch.Tensor:
    """Route samples through one tree: (n,) leaf weights ((n, K) for a
    K-channel leaf table)."""
    idx = leaf_index(binned, tree.feature, tree.threshold, max_depth)
    return tree.leaf_weight[idx.long()]


def predict_trees(trees: TreeArrays, binned: torch.Tensor,
                  max_depth: int) -> torch.Tensor:
    """Per-tree outputs of a stacked forest: (n_trees, n[, K])."""
    return torch.stack([
        predict_tree(TreeArrays(*(a[i] for a in trees)), binned, max_depth)
        for i in range(trees.feature.shape[0])
    ])


def predict_forest(trees: TreeArrays, binned: torch.Tensor,
                   max_depth: int) -> torch.Tensor:
    """Mean over a stacked forest (bagging combiner of Alg. 1 line 7)."""
    return _mean0(predict_trees(trees, binned, max_depth))


def _mean0(per_tree: torch.Tensor) -> torch.Tensor:
    # sum, then divide, on every device: torch.mean on CUDA multiplies by
    # the reciprocal instead, which is not what jnp.mean does
    return per_tree.sum(0) / per_tree.shape[0]


def _margin_init(n: int, leaf: torch.Tensor, base_score: float
                 ) -> torch.Tensor:
    """(n,) for a 2-D (trees, leaves) table, (n, K) for the 3-D one."""
    shape = (n,) if leaf.ndim == 2 else (n, leaf.shape[-1])
    return torch.full(shape, base_score, dtype=torch.float32,
                      device=leaf.device)


def predict_packed(packed: PackedEnsemble, binned: torch.Tensor
                   ) -> torch.Tensor:
    """Raw margin with the exact per-round combiner:
    ``base + sum_r lr * mean_r(per_tree)`` over the static round offsets."""
    out = _margin_init(binned.shape[0], packed.leaf_weight,
                       packed.base_score)
    for r in range(packed.rounds):
        per_tree = predict_trees(packed.round_trees(r), binned,
                                 packed.max_depth)
        out = out + packed.learning_rate * _mean0(per_tree)
    return out


def predict_packed_weighted(packed: PackedEnsemble, binned: torch.Tensor
                            ) -> torch.Tensor:
    """Single-pass combiner ``base + sum_t tree_scale[t] * tree_t(x)``,
    accumulated in tree order from ``base`` (the JAX ``lax.scan``)."""
    out = _margin_init(binned.shape[0], packed.leaf_weight,
                       packed.base_score)
    for t in range(packed.total_trees):
        tree = TreeArrays(packed.feature[t], packed.threshold[t],
                          packed.gain[t], packed.leaf_weight[t])
        out = out + packed.tree_scale[t] * predict_tree(
            tree, binned, packed.max_depth)
    return out


def predict_tree_values(x: torch.Tensor, feature: torch.Tensor,
                        thr_value: torch.Tensor, leaf: torch.Tensor,
                        max_depth: int) -> torch.Tensor:
    """``predict_tree`` on RAW floats via the value-space threshold table:
    (n[, K]) leaf values, leaf-index-identical to binning + the bin-space
    ``predict_tree``."""
    idx = leaf_index(x, feature, thr_value, max_depth)
    return leaf[idx.long()]


def predict_packed_fused(model: PackedEnsemble, x: torch.Tensor
                         ) -> torch.Tensor:
    """Fused bin+traverse margin on raw floats (``tree.py:572-601``): the
    ``predict_packed_weighted`` accumulation, started from ``base``, with
    the binning pass folded into value-space thresholds."""
    feature, thr_value, leaf, tree_scale = serving_tables(model)
    out = _margin_init(x.shape[0], leaf, model.base_score)
    for t in range(feature.shape[0]):
        out = out + tree_scale[t] * predict_tree_values(
            x, feature[t], thr_value[t], leaf[t], model.max_depth)
    return out
