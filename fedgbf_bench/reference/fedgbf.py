"""Plain FedGBF in PyTorch, the yardstick that decides ``correct``.

Written from the paper (Algs. 1-3, eqs. 1 and 4) and the TreeConfig
semantics, not from the program: quantile binning with linear
interpolation, logistic gradients, per-level histograms, the exact split
gain, ``bin <= threshold`` goes left, leaf weights ``-G / (H + lambda)``,
and the bagged round mean added at the learning rate.  It imports nothing
of the program and takes nothing the program made: the inputs come from
the harness, the masks from ``draws``, the bin edges from its own
quantiles (a job's edge replaces one only where both are float32
roundings of the same quantile, see ``grow``).  A configuration field or
value it does not implement is refused (``refuse_unimplemented``), never
judged against the wrong yardstick.

``grow`` builds a job's trees in two ways:

* free, choosing every split itself: run in a lower precision, this is the
  control that a sound comparison must refuse;
* following a given structure (the program's features and thresholds):
  it routes the rows as that structure does, judges every split by how far
  its gain lies below the best gain there, and works out the leaves and
  margins itself.  A split chosen differently on a near tie then costs a
  rounding-sized gap and does not cascade into the later trees.

Everything runs on the CPU, after the measured window.
"""

from __future__ import annotations

import numpy as np
import torch

from fedgbf_bench.reference import draws

NEG_INF = float("-inf")
#: two edges this many float32 ulps of their order statistics apart, or
#: fewer, are roundings of the same quantile (a single rounding of the
#: interpolation's product and one of its sum lie within 1 of the exact)
SNAP_ULPS = 4.0

#: the configuration fields this reference implements, each with the
#: values it implements (None: any)
MODEL_FIELDS = {"rounds": None, "learning_rate": None, "loss": ("logistic",),
                "sampling": ("uniform",), "base_score": None,
                "n_trees_max": None, "n_trees_min": None,
                "n_trees_speed": None, "rho_id_min": None, "rho_id_max": None,
                "rho_id_speed": None, "rho_feat": None}
TREE_FIELDS = {"max_depth": None, "num_bins": None, "lambda_": None,
               "gamma": None, "min_child_weight": None,
               "hist_subtraction": None, "max_active_nodes": (0,),
               "shared_root": (False,)}


def refuse_unimplemented(model: dict, tree: dict) -> None:
    """Raise ``ValueError`` for a field of ``model`` or ``tree`` that this
    reference does not know, or a value of it that it does not implement
    (GOSS sampling, another loss, frontier compaction, a shared root)."""
    bad = []
    for what, given, fields in (("model", model, MODEL_FIELDS),
                                ("tree", tree, TREE_FIELDS)):
        for key, value in given.items():
            if key not in fields:
                bad.append(f"{what}.{key}")
            elif fields[key] is not None and value not in fields[key]:
                bad.append(f"{what}.{key}={value!r}")
    if bad:
        raise ValueError("the plain reference does not implement "
                         + ", ".join(bad))


def quantile_edges(x: torch.Tensor, num_bins: int,
                   with_ulp: bool = False):
    """(d, B - 1) edges at the quantiles k / B, k = 1 .. B - 1, linearly
    interpolated between order statistics, in ``x``'s dtype.  With
    ``with_ulp`` also the float32 unit in the last place of the larger
    of each edge's two order statistics: the scale of a float32 rounding
    of that interpolation."""
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    k = torch.arange(1, num_bins, dtype=torch.float64)
    pos = k * (n - 1) / num_bins
    low = torch.floor(pos).long()
    high = torch.ceil(pos).long()
    w = (pos - low).to(x.dtype)[:, None]
    edges = (s[low] * (1 - w) + s[high] * w).T.contiguous()
    if not with_ulp:
        return edges
    scale = torch.maximum(s[low].abs(), s[high].abs()).T.float().numpy()
    ulp = torch.from_numpy(np.spacing(scale).astype(np.float64))
    return edges, ulp


def bin_data(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, d) bin ids: the number of a column's edges strictly below the
    value."""
    return torch.searchsorted(edges.contiguous(), x.T.contiguous(),
                              right=False).T.contiguous()


def _histogram(bins, node, stats, rows, nodes, num_bins):
    """(nodes, d, B, S) sums of ``stats`` (n, S) over ``rows``."""
    b = bins[rows]
    m, d = b.shape
    ids = ((node[rows][:, None] * d + torch.arange(d)) * num_bins + b)
    out = torch.zeros((nodes * d * num_bins, stats.shape[1]),
                      dtype=stats.dtype)
    out.index_add_(0, ids.reshape(-1),
                   stats[rows].repeat_interleave(d, dim=0))
    return out.reshape(nodes, d, num_bins, stats.shape[1])


def _gains(hist, fmask, tree: dict):
    """(nodes, d, B) gain of the split ``bin <= b`` (eq. 1); -inf where a
    child holds less than ``min_child_weight`` hessian, at the last bin and
    on masked features."""
    lam = tree["lambda_"]
    cum = torch.cumsum(hist, dim=2)
    tot = cum[:, :, -1:, :]
    gl, hl = cum[..., 0], cum[..., 1]
    gt, ht = tot[..., 0], tot[..., 1]
    gr, hr = gt - gl, ht - hl
    gain = 0.5 * (gl * gl / (hl + lam) + gr * gr / (hr + lam)
                  - gt * gt / (ht + lam)) - tree["gamma"]
    num_bins = hist.shape[2]
    mcw = tree["min_child_weight"]
    valid = ((hl >= mcw) & (hr >= mcw)
             & (torch.arange(num_bins) < num_bins - 1) & fmask[None, :, None])
    return torch.where(valid, gain, torch.full_like(gain, NEG_INF))


def grow(x: np.ndarray, y: np.ndarray, model: dict, tree: dict, seed: int,
         dtype=torch.float64, follow: dict | None = None) -> dict:
    """One FedGBF job: ``model`` holds the schedule (rounds, trees, sample
    rates, learning rate, base score), ``tree`` the TreeConfig fields.

    The rows are binned on the reference's own edges; with ``follow``, a
    followed edge within ``SNAP_ULPS`` of the reference's own takes its
    place.  Returns ``edges`` (d, B - 1), ``feature`` / ``threshold``
    (S, 2**D - 1), ``leaf`` (S, 2**D) and ``margin`` (n,), all float32 or
    int64 numpy.
    With ``follow`` (a dict of the same keys, the structure to judge) it
    also returns per-edge ``edge_ulps`` (the followed edge's distance from
    the reference's in float32 ulps of its order statistics), per-node
    ``gap`` (how far the followed split's gain lies below the best) and
    ``best`` (the best gain), and per-leaf ``count``.
    """
    refuse_unimplemented(model, tree)
    depth, num_bins = tree["max_depth"], tree["num_bins"]
    xt = torch.from_numpy(np.asarray(x, np.float32))
    edge_ulps = None
    if dtype == torch.float64:
        edges, ulp = quantile_edges(xt.double(), num_bins, with_ulp=True)
        edges = edges.float()
        bin_edges = edges
        if follow is not None:
            # the followed job's edge replaces the reference's own only
            # where the two are float32 roundings of one quantile, within
            # SNAP_ULPS: a data value tied at the quantile (counts, the
            # missing-value sentinel) then falls on the side the job put
            # it, rather than in the next bin
            theirs = torch.from_numpy(np.asarray(follow["edges"],
                                                 np.float32))
            edge_ulps = (theirs.double() - edges.double()).abs() / ulp
            bin_edges = torch.where(edge_ulps <= SNAP_ULPS, theirs, edges)
        bins = bin_data(xt, bin_edges)
    else:
        xt = xt.to(dtype)
        edges = quantile_edges(xt, num_bins)
        bins = bin_data(xt, edges)
    n, d = bins.shape
    yt = torch.from_numpy(np.asarray(y, np.float32)).to(dtype)
    sample, feature_mask = draws.step_masks(model, n, d, seed)
    sample = torch.from_numpy(sample)
    feature_mask = torch.from_numpy(feature_mask)
    trees = draws.trees_per_round(model)
    lr = torch.tensor(model["learning_rate"], dtype=dtype)
    margin = torch.full((n,), model["base_score"], dtype=dtype)
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    s_total = sum(trees)
    feat = torch.full((s_total, n_int), -1, dtype=torch.long)
    thr = torch.full((s_total, n_int), num_bins, dtype=torch.long)
    leaf = torch.zeros((s_total, n_leaf), dtype=dtype)
    count = torch.zeros((s_total, n_leaf), dtype=dtype)
    gap = torch.zeros((s_total, n_int), dtype=dtype)
    best_gain = torch.zeros((s_total, n_int), dtype=dtype)
    if follow is not None:
        feat = torch.as_tensor(np.asarray(follow["feature"]), dtype=torch.long)
        thr = torch.as_tensor(np.asarray(follow["threshold"]),
                              dtype=torch.long)
    step = 0
    for t_round in trees:
        p = torch.sigmoid(margin)
        stats = torch.stack([p - yt, p * (1 - p), torch.ones_like(p)], dim=1)
        outs = []
        for _ in range(t_round):
            rows = torch.nonzero(sample[step]).squeeze(1)
            node = torch.zeros((n,), dtype=torch.long)
            for level in range(depth):
                width, off = 2 ** level, 2 ** level - 1
                hist = _histogram(bins, node, stats, rows, width, num_bins)
                gains = _gains(hist, feature_mask[step], tree)
                flat = gains.reshape(width, d * num_bins)
                best = flat.max(dim=1)
                if follow is None:
                    split = best.values > 0
                    feat[step, off:off + width] = torch.where(
                        split, best.indices // num_bins, -1)
                    thr[step, off:off + width] = torch.where(
                        split, best.indices % num_bins, num_bins)
                else:
                    f = feat[step, off:off + width]
                    t = thr[step, off:off + width]
                    ok = (f >= 0) & (f < d) & (t >= 0) & (t <= num_bins - 2)
                    chosen = gains[torch.arange(width), f.clamp(0, d - 1),
                                   t.clamp(0, num_bins - 1)]
                    chosen = torch.where(ok, chosen, torch.full_like(
                        chosen, NEG_INF))
                    chosen = torch.where(f == -1, torch.zeros_like(chosen),
                                         chosen)
                    top = best.values.clamp(min=0)
                    gap[step, off:off + width] = top - chosen
                    best_gain[step, off:off + width] = best.values
                f = feat[step, off:off + width][node]
                t = thr[step, off:off + width][node]
                fv = bins.gather(1, f.clamp(0, d - 1)[:, None]).squeeze(1)
                node = node * 2 + ((f >= 0) & (fv > t)).long()
            sums = torch.zeros((n_leaf, 3), dtype=dtype)
            sums.index_add_(0, node[rows], stats[rows])
            w = torch.where(sums[:, 2] > 0, -sums[:, 0] / (
                sums[:, 1] + tree["lambda_"]), torch.zeros_like(sums[:, 0]))
            leaf[step] = w
            count[step] = sums[:, 2]
            outs.append(w[node])
            step += 1
        margin = margin + lr * torch.stack(outs).mean(dim=0)
    out = {"edges": edges.float().numpy(), "feature": feat.numpy(),
           "threshold": thr.numpy(), "leaf": leaf.float().numpy(),
           "margin": margin.float().numpy()}
    if follow is not None:
        out.update(edge_ulps=edge_ulps.numpy(), gap=gap.numpy(),
                   best=best_gain.numpy(),
                   count=count.numpy(), leaf_exact=leaf.numpy(),
                   margin_exact=margin.numpy())
    return out


def _scale(values: np.ndarray, floor: float) -> np.ndarray:
    """``max(|value|, floor)``: a gap measured against its own size or a
    typical one, whichever is larger."""
    return np.maximum(np.abs(values), floor)


def judge(x: np.ndarray, y: np.ndarray, model: dict, tree: dict, seed: int,
          job: dict) -> dict:
    """The readings of one job's outputs (``job``: ``edges``, ``feature``,
    ``threshold``, ``leaf``, ``margin``) against the plain reference
    following its structure:

    * ``edge_gap``: the largest distance of an edge from the reference's,
      in float32 ulps of the larger of its two order statistics;
    * ``split_gap``: the largest shortfall of a chosen split's gain below
      the best gain at its node, over that node's best gain or the median
      best gain of the job's split nodes, whichever is larger;
    * ``leaf_gap``: the largest leaf weight difference over the leaf's
      |weight| or the median |weight| of the job's non-empty leaves;
    * ``margin_gap``: the largest final margin difference (margins are
      O(1)).
    """
    ref = grow(x, y, model, tree, seed, follow=job)
    edge_gap = float(ref["edge_ulps"].max())
    best = ref["best"]
    positive = best[best > 0]
    floor = float(np.median(positive)) if positive.size else 1.0
    split_gap = float((ref["gap"] / _scale(np.maximum(best, 0), floor)).max())
    w_r = ref["leaf_exact"]
    filled = np.abs(w_r[ref["count"] > 0])
    floor = float(np.median(filled)) if filled.size else 1.0
    w_p = np.asarray(job["leaf"], np.float64)
    leaf_gap = float((np.abs(w_p - w_r) / _scale(w_r, floor)).max())
    m_p = np.asarray(job["margin"], np.float64)
    margin_gap = float(np.abs(m_p - ref["margin_exact"]).max())
    return {"edge_gap": edge_gap, "split_gap": split_gap,
            "leaf_gap": leaf_gap, "margin_gap": margin_gap}


def value_thresholds(feature, threshold, edges):
    """(S, I) raw-value thresholds: ``bin(v) <= t`` is ``v <= edges[f, t]``;
    +inf (everything left) where a node does not split."""
    d, n_edges = edges.shape
    split = (feature >= 0) & (feature < d) & (threshold >= 0) & (
        threshold <= n_edges - 1)
    vals = edges[feature.clamp(0, d - 1), threshold.clamp(0, n_edges - 1)]
    return torch.where(split, vals, torch.full_like(vals, float("inf")))


def score(x: np.ndarray, ensemble: dict, dtype=torch.float64,
          block: int = 65536) -> np.ndarray:
    """Scores of raw rows ``x`` (m, d): the sigmoid of ``base + sum over
    rounds of lr * mean over the round's trees of the leaf each row
    reaches``.  ``ensemble``: ``feature`` / ``threshold`` (S, I) int,
    ``leaf`` (S, L), ``edges`` (d, B - 1), ``trees`` per round, ``lr``,
    ``base``, ``depth``."""
    feature = torch.as_tensor(np.asarray(ensemble["feature"]),
                              dtype=torch.long)
    threshold = torch.as_tensor(np.asarray(ensemble["threshold"]),
                                dtype=torch.long)
    edges = torch.as_tensor(np.asarray(ensemble["edges"], np.float32))
    leaf = torch.as_tensor(np.asarray(ensemble["leaf"], np.float32))
    if dtype != torch.float64:
        edges, leaf = edges.to(dtype), leaf.to(dtype)
    else:
        leaf = leaf.double()
    thr = value_thresholds(feature, threshold, edges)
    depth = ensemble["depth"]
    d = edges.shape[0]
    trees = ensemble["trees"]
    bounds = np.concatenate([[0], np.cumsum(trees)])
    lr = torch.tensor(ensemble["lr"], dtype=dtype)
    out = []
    for a in range(0, x.shape[0], block):
        xb = torch.from_numpy(np.asarray(x[a:a + block], np.float32))
        if dtype != torch.float64:
            xb = xb.to(dtype)
        xt = xb.T.contiguous()                                   # (d, m)
        idx = torch.zeros((feature.shape[0], xb.shape[0]), dtype=torch.long)
        for level in range(depth):
            node = idx + (2 ** level - 1)
            f = feature.gather(1, node)
            t = thr.gather(1, node)
            v = xt.gather(0, f.clamp(0, d - 1))
            idx = idx * 2 + ((f >= 0) & (v > t)).long()
        per_tree = leaf.gather(1, idx)                           # (S, m)
        acc = torch.full((xb.shape[0],), ensemble["base"], dtype=dtype)
        for r in range(len(trees)):
            acc = acc + lr * per_tree[bounds[r]:bounds[r + 1]].mean(dim=0)
        out.append(torch.sigmoid(acc).double().numpy())
    return np.concatenate(out) if out else np.zeros(0)
