"""Port vs JAX package: leaf routing, the kernels' plain versions against
the Pallas kernels (interpret mode, as ``ops.py`` runs them off-TPU), and
every ``predict`` impl (CPU).

Tolerances: leaf routing is exact. JAX's CPU backend contracts every
accumulation step ``acc + scale * leaf`` into one FMA, in the scan of
``fused``/``weighted`` and in the interpret-mode Pallas kernels alike;
the port takes the same step (``core.fma``, ``__fmaf_rn`` in the CUDA
kernels), so those margins are exact. ``packed`` and ``loop`` are exact
too: their per-round mean is ``jnp.mean`` as XLA's CPU backend computes
it (the sum in tree order times the float32 ``1 / k``; ``tree._mean0``).
1e-6 stays where the two programs differ by design: the kernel wrappers
against a base-first JAX path at a non-zero base (the CUDA kernels, like
the JAX Pallas wrappers, start from 0 and add ``base_score`` last), and
the activations (``torch.sigmoid`` and ``jax.nn.sigmoid`` may differ in
the last ulp). Interpret mode is slow, so the Pallas cases use at most 8
trees and 300 rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as j_boosting
from repro.core import tree as j_tree
from repro.core.types import TreeArrays as JTreeArrays
from repro.core.types import float_thresholds as j_float_thresholds
from repro.kernels.ensemble_predict import ensemble_predict as j_kernels
from repro.kernels.ensemble_predict import ops as j_ops
from repro_torch.core import binning as t_binning
from repro_torch.core import boosting as t_boosting
from repro_torch.core import tree as t_tree
from repro_torch.core.types import TreeArrays as TTreeArrays
from repro_torch.kernels.ensemble_predict import ops as t_ops
from repro_torch.kernels.ensemble_predict import ref as t_ref
from torch_parity import (hard_rows, jax_packed, random_packed_arrays,
                          torch_packed)

TILE = 256


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA not available)")
    return torch.device("cuda", 0)


def _model(seed, depth=3, rounds=(3, 3, 2), d=9, base=0.0, k=None,
           loss="logistic"):
    rng = np.random.default_rng(seed)
    arrays, meta = random_packed_arrays(rng, list(rounds), depth, d, k=k,
                                        base=base, loss=loss)
    x = hard_rows(rng, 300, arrays["bin_edges"])
    return arrays, meta, x


@pytest.mark.parametrize("raw", [False, True], ids=["binned", "raw"])
@pytest.mark.parametrize("depth", [1, 4])
def test_leaf_routing_exact(raw, depth):
    """Per-tree leaf indices: leaves carry their own index, so equal outputs
    are equal routing."""
    arrays, meta, x = _model(depth, depth=depth, rounds=(8,))
    leaf = np.tile(np.arange(2 ** depth, dtype=np.float32), (8, 1))
    edges = arrays["bin_edges"]
    binned = np.array(j_binning_bin(x, edges))
    for t in range(8):
        f, thr = arrays["feature"][t], arrays["threshold"][t]
        if raw:
            thr_v = np.array(j_float_thresholds(
                jnp.asarray(f), jnp.asarray(thr), jnp.asarray(edges)))
            want = j_tree.predict_tree_values(
                jnp.asarray(x), jnp.asarray(f), jnp.asarray(thr_v),
                jnp.asarray(leaf[t]), depth)
            got = t_tree.predict_tree_values(
                torch.from_numpy(x), torch.from_numpy(f),
                torch.from_numpy(thr_v), torch.from_numpy(leaf[t]), depth)
        else:
            g = np.zeros(f.shape, np.float32)
            want = j_tree.predict_tree(JTreeArrays(
                jnp.asarray(f), jnp.asarray(thr), jnp.asarray(g),
                jnp.asarray(leaf[t])), jnp.asarray(binned), depth)
            got = t_tree.predict_tree(TTreeArrays(
                torch.from_numpy(f), torch.from_numpy(thr),
                torch.from_numpy(g), torch.from_numpy(leaf[t])),
                torch.from_numpy(binned), depth)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def j_binning_bin(x, edges):
    from repro.core import binning as j_binning

    return j_binning.bin_data(jnp.asarray(x), jnp.asarray(edges))


@pytest.mark.parametrize("depth,n_trees", [(3, 8), (5, 3)])
@pytest.mark.parametrize("raw", [False, True], ids=["binned", "raw"])
def test_plain_kernels_match_pallas_interpret(depth, n_trees, raw):
    """ref.py against the Pallas kernels themselves (interpret mode)."""
    arrays, _, x = _model(10 + depth, depth=depth, rounds=(n_trees,))
    n = x.shape[0]
    n_pad = -(-n // TILE) * TILE
    feature = arrays["feature"]
    leaf, scale = arrays["leaf_weight"], arrays["tree_scale"] * 3.7
    edges = arrays["bin_edges"]
    if raw:
        thr = np.asarray(j_float_thresholds(
            jnp.asarray(feature), jnp.asarray(arrays["threshold"]),
            jnp.asarray(edges)))
        inp = x
        call, plain = (j_kernels.predict_forest_raw_pallas_call,
                       t_ref.predict_forest_raw_ref)
    else:
        thr = arrays["threshold"]
        inp = np.asarray(j_binning_bin(x, edges))
        call, plain = (j_kernels.predict_forest_pallas_call,
                       t_ref.predict_forest_binned_ref)
    padded = np.zeros((n_pad, inp.shape[1]), inp.dtype)
    padded[:n] = inp
    want = np.asarray(call(
        jnp.asarray(padded), jnp.asarray(feature), jnp.asarray(thr),
        jnp.asarray(leaf), jnp.asarray(scale), max_depth=depth,
        tile_n=TILE, interpret=True))[:n]
    got = plain(*(torch.from_numpy(np.ascontiguousarray(a))
                  for a in (inp, feature, thr, leaf, scale)), depth)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_match_pallas_ops():
    """The three wrappers on CPU tensors (their plain versions) against the
    JAX ``ops`` wrappers in interpret mode, non-zero base included."""
    arrays, meta, x = _model(20, base=-0.625)
    jp, tp = jax_packed(arrays, meta), torch_packed(arrays, meta)
    binned = j_binning_bin(x, arrays["bin_edges"])
    tb = torch.from_numpy(np.array(binned))
    pairs = [
        (j_ops.predict_packed_fused_pallas(jp, jnp.asarray(x),
                                           interpret=True),
         t_ops.predict_packed_fused_cuda(tp, torch.from_numpy(x))),
        (j_ops.predict_packed_pallas(jp, binned, interpret=True),
         t_ops.predict_packed_cuda(tp, tb)),
        (j_ops.predict_forest_pallas(jp.trees(), binned, 3, interpret=True),
         t_ops.predict_forest_cuda(tp.trees(), tb, 3)),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a CPU tensor never counts as a kernel launch
    assert t_ops.kernel_launches("ensemble_predict_raw") == 0
    assert t_ops.kernel_launches("ensemble_predict_binned") == 0


@pytest.mark.parametrize("base", [0.0, 0.8125])
def test_predict_impls_match_jax(base):
    arrays, meta, x = _model(30, base=base)
    jp, tp = jax_packed(arrays, meta), torch_packed(arrays, meta)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    got_by_impl = {}
    for t_impl, j_impl in (("fused", "fused"), ("weighted", "weighted"),
                           ("packed", "packed"), ("loop", "loop"),
                           ("fused-cuda", "fused"), ("cuda", "weighted")):
        want = np.asarray(j_boosting.predict(jp, jx, impl=j_impl))
        got = t_boosting.predict(tp, tx, impl=t_impl).numpy()
        if t_impl in ("fused", "weighted", "packed", "loop") or (
                base == 0.0 and t_impl in ("fused-cuda", "cuda")):
            np.testing.assert_array_equal(got, want, err_msg=t_impl)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=t_impl)
        got_by_impl[t_impl] = got
    # fused routing is binned routing; the kernels' plain versions start at
    # 0 and add base_score last, so they equal the base-first paths only
    # at base 0
    np.testing.assert_array_equal(got_by_impl["fused"],
                                  got_by_impl["weighted"])
    np.testing.assert_array_equal(got_by_impl["fused-cuda"],
                                  got_by_impl["cuda"])
    if base == 0.0:
        np.testing.assert_array_equal(got_by_impl["fused"],
                                      got_by_impl["cuda"])
    np.testing.assert_allclose(
        t_boosting.predict_proba(tp, tx, impl="fused").numpy(),
        np.asarray(j_boosting.predict_proba(jp, jx, impl="fused")),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_mean0_equals_jnp_mean(k):
    """``tree._mean0`` is ``jnp.mean(axis=0)`` bit for bit, for (k, n) and
    (k, n, K) stacks; a plain division by ``k`` is not (it differs in the
    last ulp where ``1 / k`` is inexact)."""
    rng = np.random.default_rng(60 + k)
    for shape in ((k, 1000), (k, 300, 3)):
        a = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jnp.mean(jnp.asarray(a), axis=0))
        np.testing.assert_array_equal(
            t_tree._mean0(torch.from_numpy(a)).numpy(), want)
    if k in (3, 5):
        divided = (torch.from_numpy(a).sum(0) / k).numpy()
        assert not np.array_equal(divided, want)


def test_multiclass_fused_and_kernel_refusal():
    arrays, meta, x = _model(40, k=3, loss="softmax3")
    jp, tp = jax_packed(arrays, meta), torch_packed(arrays, meta)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for impl in ("fused", "weighted", "packed"):
        got = t_boosting.predict(tp, tx, impl=impl).numpy()
        assert got.shape == (300, 3)
        want = np.asarray(j_boosting.predict(jp, jx, impl=impl))
        np.testing.assert_array_equal(got, want, err_msg=impl)
    proba = t_boosting.predict_proba(tp, tx, impl="fused")
    np.testing.assert_allclose(proba.sum(-1).numpy(), 1.0, atol=1e-6)
    for impl in ("fused-cuda", "cuda"):
        with pytest.raises(ValueError, match="K-channel"):
            t_boosting.predict(tp, tx, impl=impl)
    with pytest.raises(ValueError, match="unknown predict impl"):
        t_boosting.predict(tp, tx, impl="pallas")


def test_wrapper_checks_inputs():
    """Wrong dtype, layout or device raises; a tensor that is neither on the
    CPU nor on CUDA never reaches the plain version."""
    arrays, meta, x = _model(50)
    tp = torch_packed(arrays, meta)
    tx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="float32"):
        t_ops.predict_packed_fused_cuda(tp, tx.double())
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.predict_packed_fused_cuda(
            tp, torch.cat([tx, tx], 1)[:, ::2])
    with pytest.raises(ValueError, match="int32"):
        t_ops.predict_packed_cuda(tp, tx)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        t_ops.predict_packed_fused_cuda(tp.to("meta"), tx.to("meta"))


@pytest.mark.cuda
def test_kernels_equal_plain_on_card(cuda_device):
    """chip_smoke's kernel phase: both kernels bit-equal to their plain
    versions, and two launches bit-identical, at every case of
    ``chip_smoke.traversal_cases`` (depth 0-12, one tree to one past a
    chunk, n from 1 to 262144, d from 1 to 4096)."""
    import chip_smoke

    err = chip_smoke.phase_kernels(cuda_device)
    assert err == {"ensemble_predict_raw": 0.0,
                   "ensemble_predict_binned": 0.0}
