"""Model explainability: the counterpart of ``repro/core/explain.py``.

Gain-based and split-count feature importances over a trained ensemble
(either layout), per-party attribution (which party's features drive the
model) and a text dump of any tree.  The tables come to the host as numpy
arrays, so the numbers are the JAX package's for the same model.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.core.types import EnsembleModel, PackedEnsemble, forest_size
from repro_torch.data.tabular import VerticalPartition


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def feature_importance(model: Union[EnsembleModel, PackedEnsemble],
                       num_features: int, kind: str = "gain") -> np.ndarray:
    """Importance per feature, normalised to sum 1. kind: 'gain' (sum of
    split gains) or 'count'.

    Bagging-aware: each tree's contribution is weighted 1/n_trees of its
    round (from ``tree_scale = lr / n_trees`` in the packed layout).
    """
    if isinstance(model, PackedEnsemble):
        weights = _np(model.tree_scale).astype(np.float64) / model.learning_rate
        per_tree = zip(_np(model.feature), _np(model.gain), weights)
    else:
        per_tree = (
            (f, g, 1.0 / forest_size(trees))
            for trees in model.forests
            for f, g in zip(_np(trees.feature), _np(trees.gain))
        )
    imp = np.zeros(num_features, np.float64)
    for feats, gains, weight in per_tree:     # rows: (num_internal,) per tree
        valid = feats >= 0
        f = feats[valid]
        w = gains[valid] if kind == "gain" else np.ones_like(f, float)
        np.add.at(imp, f, w * weight)
    total = imp.sum()
    return imp / total if total > 0 else imp


def party_importance(model: Union[EnsembleModel, PackedEnsemble],
                     partition: VerticalPartition,
                     kind: str = "gain") -> dict:
    """Share of model importance contributed by each party's feature slice."""
    imp = feature_importance(model, partition.num_features, kind)
    return {
        f"party_{p}": float(imp[partition.columns(p)].sum())
        for p in range(partition.num_parties)
    }


def dump_tree(model: EnsembleModel, round_idx: int, tree_idx: int,
              feature_names=None) -> str:
    """Human-readable text rendering of one tree (bin-threshold splits)."""
    trees = model.forests[round_idx]
    feat = _np(trees.feature[tree_idx])
    thr = _np(trees.threshold[tree_idx])
    gain = _np(trees.gain[tree_idx])
    leaf = _np(trees.leaf_weight[tree_idx])
    edges = _np(model.bin_edges)
    name = (lambda f: feature_names[f]) if feature_names else (lambda f: f"f{f}")

    lines = []

    def rec(level: int, idx: int, indent: str):
        node = 2**level - 1 + idx
        if level == model.max_depth:
            lines.append(f"{indent}leaf[{idx}] = {leaf[idx]:+.5f}")
            return
        f, t = int(feat[node]), int(thr[node])
        if f < 0:
            lines.append(f"{indent}(pass-through)")
            rec(level + 1, idx * 2, indent + "  ")
            return
        cut = edges[f, t] if t < edges.shape[1] else float("inf")
        lines.append(
            f"{indent}if {name(f)} <= {cut:.4f}  (bin {t}, gain {gain[node]:.3f})"
        )
        rec(level + 1, idx * 2, indent + "  ")
        lines.append(f"{indent}else")
        rec(level + 1, idx * 2 + 1, indent + "  ")

    rec(0, 0, "")
    return "\n".join(lines)
