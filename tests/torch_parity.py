"""Shared inputs for the port's parity tests: seeded numpy tables that go
through the JAX package and the PyTorch port alike."""

from __future__ import annotations

import numpy as np

FIELDS = ("feature", "threshold", "gain", "leaf_weight", "tree_scale",
          "bin_edges")


def random_packed_arrays(rng, round_sizes, depth, d, num_bins=32, k=None,
                         lr=0.1, base=0.0, loss="logistic"):
    """(arrays, meta) of a valid packed ensemble: splits on bins [0, B-2],
    a fifth of the nodes unsplit (feature -1, threshold B), sorted edges,
    ``tree_scale = lr / n_trees`` of each round."""
    n_trees = int(sum(round_sizes))
    n_internal = 2 ** depth - 1
    feature = rng.integers(0, d, (n_trees, n_internal)).astype(np.int32)
    threshold = rng.integers(0, num_bins - 1,
                             (n_trees, n_internal)).astype(np.int32)
    unsplit = rng.random((n_trees, n_internal)) < 0.2
    feature[unsplit] = -1
    threshold[unsplit] = num_bins
    leaf_shape = (n_trees, 2 ** depth) + (() if k is None else (k,))
    arrays = {
        "feature": feature,
        "threshold": threshold,
        "gain": rng.random((n_trees, n_internal)).astype(np.float32),
        "leaf_weight": rng.normal(size=leaf_shape).astype(np.float32),
        "tree_scale": np.concatenate(
            [np.full(s, lr / s, np.float32) for s in round_sizes]),
        "bin_edges": np.sort(rng.normal(size=(d, num_bins - 1)),
                             axis=1).astype(np.float32),
    }
    meta = {"round_offsets": [0, *np.cumsum(round_sizes).tolist()],
            "learning_rate": lr, "base_score": base, "loss": loss,
            "max_depth": depth}
    return arrays, meta


def jax_packed(arrays, meta):
    import jax.numpy as jnp

    from repro.core.types import PackedEnsemble

    return PackedEnsemble(
        *(jnp.asarray(arrays[f]) for f in FIELDS),
        round_offsets=tuple(meta["round_offsets"]),
        learning_rate=meta["learning_rate"], base_score=meta["base_score"],
        loss=meta["loss"], max_depth=meta["max_depth"])


def torch_packed(arrays, meta):
    from repro_torch.convert import packed_from_numpy

    return packed_from_numpy(arrays, meta, device="cpu")


def hard_rows(rng, n, bin_edges):
    """Raw float rows with the cases routing must get right: NaN (routes
    left), ±inf (the extreme bins), values exactly on an edge, whole NaN
    and whole inf rows."""
    d = bin_edges.shape[0]
    x = rng.normal(size=(n, d)).astype(np.float32)
    on_edge = rng.random((n, d)) < 0.1
    cols = np.nonzero(on_edge)[1]
    x[on_edge] = bin_edges[cols, rng.integers(0, bin_edges.shape[1],
                                              cols.size)]
    x[rng.random((n, d)) < 0.03] = np.nan
    x[rng.random((n, d)) < 0.02] = np.inf
    x[rng.random((n, d)) < 0.02] = -np.inf
    x[0, :] = np.nan
    x[1, :] = np.inf
    x[2, :] = -np.inf
    return x


def jax_step_masks(cfg, n, d, seed=0):
    """The masks of every scheduled tree build as the JAX scan engine draws
    them up front (``boosting.py:576-591``): one split of ``PRNGKey(seed)``
    per round, one ``fold_in`` per tree slot, exact-count permutation
    masks.  Returns numpy (S, n) float32 and (S, d) bool."""
    import jax
    import jax.numpy as jnp

    from repro.core import boosting, dynamic
    from repro.core import forest as forest_mod

    _, flat = dynamic.flat_schedule(cfg)
    rng = jax.random.PRNGKey(seed)
    round_keys = []
    for _ in range(cfg.rounds):
        rng, k_round = jax.random.split(rng)
        round_keys.append(k_round)
    step_keys = jax.vmap(jax.random.fold_in)(
        jnp.stack(round_keys)[jnp.asarray(flat.round_of_step)],
        jnp.asarray(flat.tree_in_round))
    n_keep = boosting._keep_counts(cfg, n)[flat.round_of_step]
    smask, fmask = forest_mod.masks_from_keys(
        step_keys, n, d, jnp.asarray(n_keep),
        forest_mod.feature_keep_count(d, cfg.rho_feat))
    return np.asarray(smask), np.asarray(fmask)


def assert_trees_equal(t_trees, j_trees, leaf_atol=1e-5):
    """Port trees (tensors) against JAX trees (arrays): structure exact,
    leaves within ``leaf_atol``."""
    for field in ("feature", "threshold"):
        np.testing.assert_array_equal(getattr(t_trees, field).cpu().numpy(),
                                      np.asarray(getattr(j_trees, field)),
                                      err_msg=field)
    np.testing.assert_allclose(t_trees.leaf_weight.cpu().numpy(),
                               np.asarray(j_trees.leaf_weight), rtol=0,
                               atol=leaf_atol)
