"""Port vs JAX package: the histogram providers, and the histogram kernel's
three wrappers (on the CPU: the kernel's plain versions) against the Pallas
kernels in interpret mode, as ``repro/kernels/histogram/ops.py`` runs them
off-TPU.

Tolerances: the plain providers sum each segment in row order, as XLA's
CPU scatter does, so they equal the JAX providers exactly; against the
Pallas kernels, whose one-hot matmul sums in another order, 1e-5 (the
``tests/test_kernels.py`` bound).  Interpret mode is slow, so the Pallas
cases stay at n <= 2000, d <= 8, B <= 16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import histogram as j_hist
from repro.kernels.histogram import ops as j_ops
from repro_torch.core import histogram as t_hist
from repro_torch.kernels.histogram import ops as t_ops
from repro_torch.kernels.histogram import ref as t_ref

TOL = 1e-5


def _inputs(seed, n, d, num_bins, n_ids, n_trees=None, k=1,
            out_of_range=False):
    """binned, g, h, weight, assign as numpy; weight/assign are (n,) when
    ``n_trees`` is None, else (T, n).  ``out_of_range`` plants ids that
    must be dropped (and bins that land in another node's range, which
    segment_sum and the one-hot both count there)."""
    rng = np.random.default_rng(seed)
    lead = () if n_trees is None else (n_trees,)
    binned = rng.integers(0, num_bins, (n, d)).astype(np.int32)
    assign = rng.integers(0, n_ids, lead + (n,)).astype(np.int32)
    if out_of_range:
        binned[:, -1] = rng.choice([-1, num_bins, num_bins + 2, 0], n)
        assign[..., ::5] = rng.choice([-1, n_ids, n_ids + 3],
                                      assign[..., ::5].shape)
    weight = ((rng.random(lead + (n,)) < 0.5)
              * rng.choice([1.0, 1.0, 2.5], lead + (n,))).astype(np.float32)
    shape = (n,) if k == 1 else (n, k)
    g = rng.normal(size=shape).astype(np.float32)
    h = rng.uniform(0.05, 0.25, shape).astype(np.float32)
    return binned, g, h, weight, assign


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("oor", [False, True], ids=["in-range", "oor"])
def test_providers_equal_jax(k, oor):
    args = _inputs(0, 700, 6, 16, 4, k=k, out_of_range=oor)
    rargs = _inputs(1, 700, 6, 16, 4, n_trees=3, k=k, out_of_range=oor)
    np.testing.assert_array_equal(
        t_hist.compute_histogram(*_t(*args), 4, 16).numpy(),
        np.asarray(j_hist.compute_histogram(*_j(*args), 4, 16)))
    np.testing.assert_array_equal(
        t_hist.compute_round_histogram(*_t(*rargs), 4, 16).numpy(),
        np.asarray(j_hist.compute_round_histogram(*_j(*rargs), 4, 16)))
    _, g, h, w, a = args
    np.testing.assert_array_equal(
        t_hist.leaf_stats(*_t(g, h, w, a), 4).numpy(),
        np.asarray(j_hist.leaf_stats(*_j(g, h, w, a), 4)))
    _, g, h, w, a = rargs
    np.testing.assert_array_equal(
        t_hist.round_leaf_stats(*_t(g, h, w, a), 4).numpy(),
        np.asarray(j_hist.round_leaf_stats(*_j(g, h, w, a), 4)))


@pytest.mark.parametrize("k", [1, 3])
def test_child_providers_and_sibling(k):
    binned, g, h, w, a = _inputs(2, 600, 5, 16, 4, k=k)
    t_child = t_hist.as_child_fn(t_hist.compute_histogram)
    j_child = j_hist.as_child_fn(j_hist.compute_histogram)
    left_t = t_child(*_t(binned, g, h, w, a), 2, 16)
    left_j = j_child(*_j(binned, g, h, w, a), 2, 16)
    np.testing.assert_array_equal(left_t.numpy(), np.asarray(left_j))
    rb, rg, rh, rw, ra = _inputs(3, 600, 5, 16, 4, n_trees=3, k=k)
    np.testing.assert_array_equal(
        t_hist.as_round_child_fn(t_hist.compute_round_histogram)(
            *_t(rb, rg, rh, rw, ra), 2, 16).numpy(),
        np.asarray(j_hist.as_round_child_fn(j_hist.compute_round_histogram)(
            *_j(rb, rg, rh, rw, ra), 2, 16)))
    parent = t_hist.compute_histogram(*_t(binned, g, h, w, a // 2), 2, 16)
    np.testing.assert_array_equal(
        t_hist.derive_sibling(parent, left_t).numpy(),
        np.asarray(j_hist.derive_sibling(jnp.asarray(parent.numpy()),
                                         left_j)))


@pytest.mark.parametrize("base", ["segment", "cuda-fused"])
def test_root_histogram_via_delta(base):
    binned, g, h, _, _ = _inputs(4, 800, 6, 16, 1)
    rng = np.random.default_rng(5)
    w = (rng.random((3, 800)) < 0.7).astype(np.float32)  # 0/1 masks
    got = t_hist.root_histogram_via_delta(
        *_t(binned, g, h, w), 16, 400,
        base_tree_fn=t_hist.histogram_dispatch(base))
    want = j_hist.root_histogram_via_delta(*_j(binned, g, h, w), 16, 400)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    direct = t_hist.compute_round_histogram(
        *_t(binned, g, h, w, np.zeros((3, 800), np.int32)), 1, 16)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=0,
                               atol=TOL)


def test_pass_meter():
    binned, g, h, w, a = _inputs(6, 300, 4, 16, 2, n_trees=2)
    t_hist.PASS_METER = []
    try:
        t_hist.compute_round_histogram(*_t(binned, g, h, w, a), 2, 16)
        t_hist.root_histogram_via_delta(*_t(binned, g, h, (w > 0).astype(
            np.float32)), 16, 64)
        assert t_hist.PASS_METER == [
            {"tag": "round", "rows": 300, "trees": 2},
            {"tag": "round", "rows": 300, "trees": 1},
            {"tag": "root_delta", "rows": 64, "trees": 2}]
    finally:
        t_hist.PASS_METER = None


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("child", [False, True], ids=["direct", "child"])
@pytest.mark.parametrize("oor", [False, True], ids=["in-range", "oor"])
def test_round_kernel_wrapper_vs_pallas(k, child, oor):
    nodes = 2
    n_ids = 2 * nodes if child else nodes
    binned, g, h, w, a = _inputs(7, 1000, 6, 16, n_ids, n_trees=3, k=k,
                                 out_of_range=oor)
    t_ops.reset_launches()
    got = t_ops.compute_round_histogram_cuda_fused(
        *_t(binned, g, h, w, a), nodes, 16, child=child)
    assert t_ops.kernel_launches("histogram_round") == 0  # CPU: plain
    want = j_ops.compute_round_histogram_pallas_fused(
        *_j(binned, g, h, w, a), nodes, 16, child=child)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if not oor:  # in range, the round fold and the per-tree drop agree
        plain = (t_hist.as_round_child_fn(t_hist.compute_round_histogram)
                 if child else t_hist.compute_round_histogram)
        np.testing.assert_array_equal(
            got.numpy(), plain(*_t(binned, g, h, w, a), nodes, 16).numpy())


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("oor", [False, True], ids=["in-range", "oor"])
def test_tree_and_staged_wrappers_vs_pallas(k, oor):
    binned, g, h, w, a = _inputs(8, 1200, 8, 16, 4, k=k, out_of_range=oor)
    tt, jj = _t(binned, g, h, w, a), _j(binned, g, h, w, a)
    for t_fn, j_fn in (
            (t_ops.compute_histogram_cuda_fused,
             j_ops.compute_histogram_pallas_fused),
            (t_ops.compute_histogram_cuda, j_ops.compute_histogram_pallas)):
        np.testing.assert_allclose(t_fn(*tt, 4, 16).numpy(),
                                   np.asarray(j_fn(*jj, 4, 16)), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(
        t_ops.compute_histogram_cuda_fused_child(*tt, 2, 16).numpy(),
        np.asarray(j_ops.compute_histogram_pallas_fused_child(*jj, 2, 16)),
        rtol=TOL, atol=TOL)
    # the plain versions in the kernel's argument order, exact vs JAX
    np.testing.assert_array_equal(
        t_ref.histogram_staged_ref(
            torch.from_numpy(a[:, None] * 16 + binned),
            t_hist.stack_stats(*_t(g, h, w)), 4, 16).numpy(),
        np.asarray(j_hist.compute_histogram(*jj, 4, 16)))


def test_dispatch_names_and_wrapper_checks():
    for name in t_hist.HISTOGRAM_IMPLS:
        assert callable(t_hist.histogram_dispatch(name))
    assert t_hist.histogram_dispatch("cuda") is t_ops.compute_histogram_cuda
    with pytest.raises(ValueError, match="unknown histogram impl"):
        t_hist.histogram_dispatch("pallas")
    binned, g, h, w, a = _t(*_inputs(9, 50, 3, 16, 2, n_trees=2))
    g2, h2 = g[:, None].contiguous(), h[:, None].contiguous()
    with pytest.raises(ValueError, match="int32"):
        t_ops.histogram_round(binned.long(), a, g2, h2, w, 2, 16, False)
    with pytest.raises(ValueError, match="float32"):
        t_ops.histogram_round(binned, a, g2.double(), h2, w, 2, 16, False)
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.histogram_round(binned, a, g2, h2, w.T.contiguous().T, 2, 16,
                              False)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        t_ops.histogram_round(*(x.to("meta") for x in (binned, a, g2, h2,
                                                       w)), 2, 16, False)


def test_single_row_and_empty():
    binned, g, h, w, a = _inputs(10, 1, 4, 16, 2, n_trees=2)
    got = t_ops.compute_round_histogram_cuda_fused(*_t(binned, g, h, w, a),
                                                   2, 16)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(j_hist.compute_round_histogram(*_j(binned, g, h, w, a),
                                                  2, 16)))
    empty = t_ops.compute_histogram_cuda_fused(
        *_t(binned[:0], g[:0], h[:0], w[0, :0], a[0, :0]), 2, 16)
    assert empty.shape == (2, 4, 16, 3) and not empty.any()

