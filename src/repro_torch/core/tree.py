"""Level-wise tree construction and traversal: the counterpart of
``repro/core/tree.py``.

Build half: ``build_round`` grows all T trees of a boosting round level by
level, with the tree axis explicit in every provider (histograms take and
return ``(T, ...)``), as the JAX package's round engine does: sibling
subtraction, frontier compaction (``max_active_nodes``) and shared-root
level-0 histograms included.  The providers come from a
``core.backend.TreeBackend``; where the JAX package lifts a per-tree
provider with ``jax.vmap``, the port loops over the tree axis.

Prediction half: the single-pass combiners (``predict_packed_weighted``,
``predict_packed_fused``) add each tree as one FMA, ``acc + scale * leaf``
rounded once (``core.fma``), because XLA's CPU backend contracts that step
of their ``lax.scan``: their margins equal the JAX package's bit for bit.
``predict_packed`` and ``predict_forest`` take each round's mean as XLA
computes ``jnp.mean`` (``_mean0``: the sum in tree order times the float32
``1 / k``) and add ``lr * mean`` in two roundings, as written: equal to
the JAX package's margins bit for bit too.  The
tree axis that ``jax.vmap`` / ``lax.scan`` walked is a Python loop here;
the hand kernels in ``kernels/ensemble_predict`` replace that loop on the
card.
"""

from __future__ import annotations

import torch

from repro_torch.core import histogram as hist_mod
from repro_torch.core import split as split_mod
from repro_torch.core.fma import fma
from repro_torch.core.types import (
    PackedEnsemble,
    TreeArrays,
    TreeConfig,
    serving_tables,
)
from repro_torch.obs import trace as trace_mod


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
    """``jnp.mean(per_tree, axis=0)`` as XLA's CPU backend computes it: the
    trees summed in order, then one multiply by the float32 reciprocal
    ``1 / k`` (XLA rewrites the division by a constant so).  A division
    by ``k`` differs from it in the last ulp."""
    total = per_tree[0]
    for p in per_tree[1:]:
        total = total + p
    return total * (1.0 / per_tree.shape[0])


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
    accumulated in tree order from ``base`` (the JAX ``lax.scan``), one FMA
    a tree."""
    out = _margin_init(binned.shape[0], packed.leaf_weight,
                       packed.base_score)
    for t in range(packed.total_trees):
        tree = TreeArrays(packed.feature[t], packed.threshold[t],
                          packed.gain[t], packed.leaf_weight[t])
        out = fma(packed.tree_scale[t],
                  predict_tree(tree, binned, packed.max_depth), out)
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
        out = fma(tree_scale[t], predict_tree_values(
            x, feature[t], thr_value[t], leaf[t], model.max_depth), out)
    return out


# ---------------------------------------------------------------------------
# Build half: routing and the round-native level loop
# ---------------------------------------------------------------------------
def route_local(binned: torch.Tensor, assign: torch.Tensor,
                decision) -> torch.Tensor:
    """Centralized routing: one ``traverse_level`` step over the frontier."""
    return traverse_level(binned, assign, decision.feature,
                          decision.threshold)


def traverse_level_round(binned: torch.Tensor, idx: torch.Tensor,
                         feature: torch.Tensor,
                         threshold: torch.Tensor) -> torch.Tensor:
    """Round-native ``traverse_level``: idx (T, n), feature / threshold
    (T, width) -> (T, n) next-level node index."""
    node = idx.long()
    f = torch.gather(feature, 1, node)
    t = torch.gather(threshold, 1, node)
    col = f.clamp(0, binned.shape[1] - 1).long()
    fv = torch.gather(binned, 1, col.T).T                    # (T, n)
    go_right = (f >= 0) & (fv > t)
    return idx * 2 + go_right.to(torch.int32)


def route_local_round(binned: torch.Tensor, assign: torch.Tensor,
                      decision) -> torch.Tensor:
    """Centralized round routing: one batched ``traverse_level`` step."""
    return traverse_level_round(binned, assign, decision.feature,
                                decision.threshold)


def _stack_decisions(decisions) -> split_mod.SplitDecision:
    return split_mod.SplitDecision(*(torch.stack(f)
                                     for f in zip(*decisions)))


def _derive_round_hist(per_tree_fn):
    """Lift a per-tree histogram provider to the round contract, one call
    per tree; shared-root level 0 goes through ``root_histogram_via_delta``
    with the per-tree provider as its accumulator."""

    def fn(binned, g, h, weight, assign, num_nodes, num_bins,
           root_delta_rows=0, level=0):
        if root_delta_rows:
            return hist_mod.root_histogram_via_delta(
                binned, g, h, weight, num_bins, root_delta_rows,
                base_tree_fn=per_tree_fn)
        return torch.stack([
            per_tree_fn(binned, g, h, w, a, num_nodes, num_bins)
            for w, a in zip(weight, assign)])

    return fn


def _derive_round_choose(per_tree_fn):
    return lambda hist, fmask: _stack_decisions(
        per_tree_fn(ht, fm) for ht, fm in zip(hist, fmask))


def _derive_round_route(per_tree_fn):
    def fn(binned, assign, decision):
        return torch.stack([
            per_tree_fn(binned, a, split_mod.SplitDecision(*d))
            for a, d in zip(assign, zip(*decision))])

    return fn


def _derive_round_leaf(per_tree_fn):
    def fn(g, h, weight, assign, num_leaves):
        return torch.stack([per_tree_fn(g, h, w, a, num_leaves)
                            for w, a in zip(weight, assign)])

    return fn


def _round_providers(cfg: TreeConfig, backend):
    """The round-native providers: a backend's ``round_*`` provider wins, a
    per-tree provider is lifted over the tree axis, and None selects the
    plain round-native default."""
    hist_fn = choose_fn = route_fn = leaf_fn = child_fn = None
    if backend is not None:
        hist_fn = backend.round_histogram_fn
        if hist_fn is None and backend.histogram_fn is not None:
            hist_fn = _derive_round_hist(backend.histogram_fn)
        choose_fn = backend.round_choose_fn
        if choose_fn is None and backend.choose_fn is not None:
            choose_fn = _derive_round_choose(backend.choose_fn)
        route_fn = backend.round_route_fn
        if route_fn is None and backend.route_fn is not None:
            route_fn = _derive_round_route(backend.route_fn)
        leaf_fn = backend.round_leaf_fn
        if leaf_fn is None and backend.leaf_fn is not None:
            leaf_fn = _derive_round_leaf(backend.leaf_fn)
        child_fn = backend.round_child_histogram_fn
        if child_fn is None and backend.child_histogram_fn is not None:
            child_fn = _derive_round_hist(backend.child_histogram_fn)
    if hist_fn is None:
        hist_fn = hist_mod.compute_round_histogram
    if choose_fn is None:
        def choose_fn(hist, fm):
            return split_mod.choose_splits_round(hist, fm, cfg)
    if route_fn is None:
        route_fn = route_local_round
    if leaf_fn is None:
        leaf_fn = hist_mod.round_leaf_stats
    if cfg.hist_subtraction and child_fn is None:
        # any round provider adapts into the child-only provider
        child_fn = hist_mod.as_round_child_fn(hist_fn)
    return hist_fn, child_fn, choose_fn, route_fn, leaf_fn


def _scatter_level(values: torch.Tensor, slot_node: torch.Tensor,
                   width: int, fill) -> torch.Tensor:
    """(T, A) slot values into a (T, width) level table at ``slot_node``."""
    out = torch.full((values.shape[0], width), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_(1, slot_node.long(), values)


def build_round(binned: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                sample_mask: torch.Tensor, feature_mask: torch.Tensor,
                cfg: TreeConfig, backend=None,
                root_delta_rows: int = 0) -> tuple[TreeArrays, torch.Tensor]:
    """Build ALL T trees of one round; returns (stacked trees, (T, n) leaf
    assignment).

    Every sample is routed in every tree so the caller can update the
    margins of the whole training set; masked-out samples contribute to no
    histogram and no leaf weight.

    Args:
      binned: (n, d) int32 binned features.
      g, h: (n,) float32 derivatives shared by the round ((n, K) at K > 1).
      sample_mask: (T, n) float32 per-tree weights — P_m(j) of eq. 4.
      feature_mask: (T, d) bool per-tree masks — Q_m(j) of eq. 4.
      cfg: tree config.  ``hist_subtraction`` accumulates only left
        children at levels >= 1 and derives the right siblings;
        ``max_active_nodes`` bounds the live frontier per level.
      backend: a ``core.backend.TreeBackend``; None = the plain providers.
      root_delta_rows: > 0 derives level 0 as shared − delta with a
        buffer of this many rows per tree.
    Returns:
      (trees, assign): stacked ``TreeArrays`` with a leading tree axis, and
      every sample's leaf index per tree.

    Each level reports four phases to the process tracer
    (``obs.trace.global_tracer``), the level in ``args``:
    ``tree.histogram`` (compaction, the histogram or child provider, the
    sibling subtraction), ``tree.split`` (the chooser and the level's
    tables), ``tree.route`` and, where compaction needs liveness counts,
    ``tree.leaf``; the final ``tree.leaf`` is the leaf statistics, their
    weights and the assembled tables.
    """
    hist_fn, child_fn, choose_fn, route_fn, leaf_fn = _round_providers(
        cfg, backend)
    tracer = trace_mod.global_tracer()
    T, n = sample_mask.shape
    device = sample_mask.device
    assign = torch.zeros((T, n), dtype=torch.int32, device=device)
    t_rows = torch.arange(T, device=device)[:, None]

    features, thresholds, gains = [], [], []
    live = None          # (T, width) next-level liveness (compacted levels)
    prev_hist = None     # (T, A_prev, d, B, S), slot space
    prev_id = prev_w = prev_a = prev_table = None
    for level in range(cfg.max_depth):
        width = 2 ** level
        a_width = cfg.active_width(level)
        compacted = a_width < width
        phase = {"level": level}
        with tracer.span("tree.histogram", cat="tree", args=phase):
            if compacted:
                # frontier compaction: live node ids first (stable,
                # ascending), so slot k < live_count holds the k-th live
                # node; dead nodes map to the trash id A (weight-masked
                # out), invalid slots to a dummy row that is never read
                order = torch.sort((~live).to(torch.int8), dim=1,
                                   stable=True).indices
                slot_node = order[:, :a_width].to(torch.int32)   # (T, A)
                live_count = live.sum(1).to(torch.int32)
                slot_valid = (torch.arange(a_width, device=device)[None, :]
                              < live_count[:, None])
                scatter_node = torch.where(slot_valid, slot_node,
                                           torch.full_like(slot_node, width))
                table = torch.full((T, width + 1), a_width,
                                   dtype=torch.int32, device=device)
                table.scatter_(1, scatter_node.long(), torch.arange(
                    a_width, dtype=torch.int32, device=device).expand(T, -1)
                    .contiguous())
                slot_assign = torch.gather(table, 1, assign.long())
                w_level = sample_mask * (slot_assign < a_width).to(
                    sample_mask.dtype)
                id_level = torch.clamp(slot_assign, max=a_width - 1)
            else:
                slot_node = table = slot_valid = None
                w_level = sample_mask
                id_level = assign

            if cfg.hist_subtraction and level >= 1:
                # accumulate only the left children at parent-slot width
                # and derive every right sibling from the carried parent
                # histograms
                side = assign % 2
                cslot = prev_id * 2 + side                 # child-slot space
                left = child_fn(binned, g, h, prev_w, cslot, prev_a,
                                cfg.num_bins, level=level)
                sib = hist_mod.derive_sibling(prev_hist, left)
                if compacted:
                    # a live slot's parent is a valid previous-level slot
                    pslot = (torch.gather(prev_table, 1,
                                          (slot_node // 2).long())
                             if prev_table is not None else slot_node // 2)
                    cidx = torch.clamp(pslot * 2 + slot_node % 2, 0,
                                       2 * prev_a - 1)
                    hist = sib[t_rows, cidx.long()]
                else:
                    hist = sib
            else:
                kw = {"level": level}
                if level == 0 and root_delta_rows:
                    kw["root_delta_rows"] = root_delta_rows
                hist = hist_fn(binned, g, h, w_level, id_level, a_width,
                               cfg.num_bins, **kw)

        with tracer.span("tree.split", cat="tree", args=phase):
            decision = choose_fn(hist, feature_mask)       # (T, A) fields
            gain_pos = torch.clamp(decision.gain, min=0.0)
            if compacted:
                feat = torch.where(slot_valid, decision.feature,
                                   torch.full_like(decision.feature, -1))
                thr = torch.where(slot_valid, decision.threshold,
                                  torch.full_like(decision.threshold,
                                                  cfg.num_bins))
                gn = torch.where(slot_valid, gain_pos,
                                 torch.zeros_like(gain_pos))
                feature_lvl = _scatter_level(feat, slot_node, width, -1)
                threshold_lvl = _scatter_level(thr, slot_node, width,
                                               cfg.num_bins)
                gain_lvl = _scatter_level(gn, slot_node, width, 0.0)
                decision_lvl = split_mod.SplitDecision(
                    feature_lvl, threshold_lvl, gain_lvl)
            else:
                feature_lvl, threshold_lvl, gain_lvl = (
                    decision.feature, decision.threshold, gain_pos)
                decision_lvl = decision
            features.append(feature_lvl)
            thresholds.append(threshold_lvl)
            gains.append(gain_lvl)
        with tracer.span("tree.route", cat="tree", args=phase):
            assign = route_fn(binned, assign, decision_lvl)

        next_level = level + 1
        if (next_level < cfg.max_depth
                and cfg.active_width(next_level) < 2 ** next_level):
            # a child is live iff its parent split and it holds weighted
            # samples; the count is the LAST stat channel at any K
            with tracer.span("tree.leaf", cat="tree", args=phase):
                counts = leaf_fn(g, h, sample_mask, assign,
                                 2 ** next_level)[..., -1]
                live = (counts > 0) & torch.repeat_interleave(
                    feature_lvl >= 0, 2, dim=1)
        else:
            live = None
        prev_hist, prev_id, prev_w = hist, id_level, w_level
        prev_a, prev_table = a_width, table

    with tracer.span("tree.leaf", cat="tree",
                     args={"level": cfg.max_depth}):
        leaf_hist = leaf_fn(g, h, sample_mask, assign, cfg.num_leaves)
        weights = split_mod.leaf_weights(leaf_hist, cfg)    # (T, L[, K])
        trees = TreeArrays(
            feature=torch.cat(features, dim=1),
            threshold=torch.cat(thresholds, dim=1),
            gain=torch.cat(gains, dim=1),
            leaf_weight=weights,
        )
    return trees, assign


def build_tree(binned: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
               sample_mask: torch.Tensor, feature_mask: torch.Tensor,
               cfg: TreeConfig, backend=None) -> tuple[TreeArrays,
                                                       torch.Tensor]:
    """Build one tree — the T = 1 case of ``build_round``: sample_mask
    (n,), feature_mask (d,) -> (tree, (n,) leaf assignment)."""
    trees, assign = build_round(binned, g, h, sample_mask[None],
                                feature_mask[None], cfg, backend=backend)
    return TreeArrays(*(a[0] for a in trees)), assign[0]
