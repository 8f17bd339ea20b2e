"""Port vs JAX package: the level-wise tree builder (CPU).

``build_round`` with sibling subtraction on and off, with frontier
compaction (``max_active_nodes``) and with shared-root level-0 histograms,
on the ``local`` and ``local-cuda`` backends (the latter runs the kernel's
plain versions here) and through per-tree providers.  Trees and the leaf
assignment must be exact; leaves within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import tree as j_tree
from repro.core.types import TreeConfig as JTreeConfig
from repro_torch.core import backend as t_backend
from repro_torch.core import histogram as t_hist
from repro_torch.core import tree as t_tree
from repro_torch.core.types import TreeConfig as TTreeConfig
from torch_parity import assert_trees_equal

N, D, B, T = 1500, 6, 16, 3


def _round_inputs(seed, k=1, keep=0.4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    binned = np.clip((x * 4 + 8).astype(np.int32), 0, B - 1)
    signal = x[:, 0] - 0.7 * x[:, 1] * (x[:, 2] > 0)
    shape = (N,) if k == 1 else (N, k)
    g = (signal.reshape(-1, 1) * (np.arange(k) - 0.5) if k > 1
         else signal) + 0.3 * rng.normal(size=shape)
    h = rng.uniform(0.05, 0.25, shape)
    smask = (rng.random((T, N)) < keep).astype(np.float32)
    fmask = rng.random((T, D)) < 0.8
    return (binned, g.astype(np.float32), h.astype(np.float32), smask,
            fmask)


CASES = {
    "subtraction": dict(max_depth=3),
    "direct": dict(max_depth=3, hist_subtraction=False),
    "compacted": dict(max_depth=5, max_active_nodes=4),
    "compacted-direct": dict(max_depth=4, max_active_nodes=3,
                             hist_subtraction=False),
}


def _jax_round(args, cfg, root_delta_rows=0):
    fn = jax.jit(lambda *a: j_tree.build_round(
        *a, cfg, root_delta_rows=root_delta_rows))
    return fn(*args)


@pytest.mark.parametrize("backend", ["local", "local-cuda"])
@pytest.mark.parametrize("case", list(CASES))
def test_build_round_equals_jax(case, backend):
    args = _round_inputs(list(CASES).index(case))
    kw = dict(num_bins=B, **CASES[case])
    want_trees, want_assign = _jax_round(args, JTreeConfig(**kw))
    got_trees, got_assign = t_tree.build_round(
        *(torch.from_numpy(a) for a in args), TTreeConfig(**kw),
        backend=t_backend.get_backend(backend))
    assert_trees_equal(got_trees, want_trees)
    np.testing.assert_array_equal(got_trees.gain.numpy(),
                                  np.asarray(want_trees.gain))
    np.testing.assert_array_equal(got_assign.numpy(),
                                  np.asarray(want_assign))


@pytest.mark.parametrize("backend", ["local", "local-cuda"])
def test_shared_root_equals_jax(backend):
    args = _round_inputs(11, keep=0.8)
    kw = dict(num_bins=B, shared_root=True)
    want_trees, want_assign = _jax_round(args, JTreeConfig(**kw), 512)
    got_trees, got_assign = t_tree.build_round(
        *(torch.from_numpy(a) for a in args), TTreeConfig(**kw),
        backend=t_backend.get_backend(backend), root_delta_rows=512)
    assert_trees_equal(got_trees, want_trees)
    np.testing.assert_array_equal(got_assign.numpy(),
                                  np.asarray(want_assign))


def test_multiclass_round_equals_jax():
    args = _round_inputs(12, k=3)
    want_trees, want_assign = _jax_round(args, JTreeConfig(num_bins=B))
    got_trees, got_assign = t_tree.build_round(
        *(torch.from_numpy(a) for a in args), TTreeConfig(num_bins=B),
        backend=t_backend.get_backend("local-cuda"))
    assert got_trees.leaf_weight.shape == (T, 8, 3)
    assert_trees_equal(got_trees, want_trees)
    np.testing.assert_array_equal(got_assign.numpy(),
                                  np.asarray(want_assign))


def test_per_tree_providers_and_build_tree():
    """A backend with only per-tree providers builds the same round, one
    tree at a time; ``build_tree`` is the T = 1 case."""
    args = [torch.from_numpy(a) for a in _round_inputs(13)]
    cfg = TTreeConfig(num_bins=B)
    round_trees, round_assign = t_tree.build_round(*args, cfg)
    per_tree = t_backend.TreeBackend(
        t_backend.BackendDescriptor("per-tree"),
        histogram_fn=t_hist.compute_histogram,
        choose_fn=lambda hist, fm: t_tree.split_mod.choose_splits(hist, fm,
                                                                  cfg),
        route_fn=t_tree.route_local,
        leaf_fn=t_hist.leaf_stats)
    trees, assign = t_tree.build_round(*args, cfg, backend=per_tree)
    for field in trees._fields:
        assert torch.equal(getattr(trees, field),
                           getattr(round_trees, field)), field
    assert torch.equal(assign, round_assign)
    binned, g, h, smask, fmask = args
    tree, leaf_of = per_tree.build_tree(binned, g, h, smask[1], fmask[1],
                                        cfg)
    want, want_assign = jax.jit(lambda *a: j_tree.build_tree(
        *a, JTreeConfig(num_bins=B)))(
        *(np.asarray(a) for a in (binned, g, h, smask[1], fmask[1])))
    assert_trees_equal(tree, want)
    np.testing.assert_array_equal(leaf_of.numpy(), np.asarray(want_assign))
