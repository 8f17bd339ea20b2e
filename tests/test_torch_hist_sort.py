"""The histogram kernel's design on the CPU: the stable slot sort (its
plain version, ``ref.sort_slots_ref``) and a model of the kernel's four
steps — count, scan, stable scatter, ordered per-slot walk — written here
from the sort's plain version and a walk over each slot's segment in
order.  The model must equal the histogram's plain version and the JAX
package's histogram bit for bit (``torch.equal``): summing each slot's rows
in segment order is summing them in row order, which is what keeps the
trees equal to the reference.  The kernel itself runs only on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import histogram as j_hist
from repro_torch.core import histogram as t_hist
from repro_torch.kernels.histogram import ops as t_ops
from repro_torch.kernels.histogram import ref as t_ref

N, D, B, T = 21000, 23, 32, 5   # the reference run's level shape


def _inputs(seed, n, d, num_bins, n_ids, n_trees, k=1, out_of_range=False):
    """binned (n, d), g / h (n, K), weight / assign (T, n) as numpy.  The
    first 9 features are Poisson(3) counts, as the synthetic credit data
    holds them (one bin then takes ~22% of the rows: a long segment).
    ``out_of_range`` puts bins and assignments the kernel must drop — or,
    where node * B + bin lands in another node's range, count there — into
    the last feature and every 7th row."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, num_bins, (n, d)).astype(np.int32)
    m = min(9, d)
    binned[:, :m] = np.minimum(rng.poisson(3.0, (n, m)), num_bins - 1)
    assign = rng.integers(0, n_ids, (n_trees, n)).astype(np.int32)
    if out_of_range:
        binned[:, -1] = rng.choice(
            [-1, num_bins, num_bins + 3, -num_bins, 0, num_bins - 1], n)
        assign[:, ::7] = rng.choice([-1, n_ids, n_ids + 2],
                                    assign[:, ::7].shape)
    weight = ((rng.random((n_trees, n)) < 0.6)
              * rng.choice([1.0, 1.0, 2.5], (n_trees, n))).astype(np.float32)
    g = rng.normal(size=(n, k)).astype(np.float32)
    h = rng.uniform(0.05, 0.25, (n, k)).astype(np.float32)
    return binned, g, h, weight, assign


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _numpy_sort(binned, assign, num_nodes, num_bins, child):
    """The sort by ``np.argsort(kind="stable")`` on int64 ids (no wrap at
    these sizes): (order with -1 tail, starts)."""
    node = assign.astype(np.int64) // 2 if child else assign.astype(np.int64)
    ids = node[:, None, :] * num_bins + binned.T[None].astype(np.int64)
    n_slots = num_nodes * num_bins
    n_trees, d, n = ids.shape
    order = np.full((n_trees, d, n), -1, np.int32)
    starts = np.zeros((n_trees, d, n_slots + 1), np.int32)
    for t in range(n_trees):
        for f in range(d):
            key = np.where((ids[t, f] >= 0) & (ids[t, f] < n_slots),
                           ids[t, f], n_slots)
            idx = np.argsort(key, kind="stable")
            kept = int((key < n_slots).sum())
            order[t, f, :kept] = idx[:kept]
            starts[t, f] = np.searchsorted(key[idx], np.arange(n_slots + 1))
    return order, starts


@pytest.mark.parametrize("child", [False, True], ids=["direct", "child"])
@pytest.mark.parametrize("oor", [False, True], ids=["in-range", "oor"])
def test_sort_plain_is_stable_and_drops_per_tree(child, oor):
    nodes = 2
    n_ids = 2 * nodes if child else nodes
    binned, _, _, _, assign = _inputs(20, 3000, 6, 16, n_ids, 3,
                                      out_of_range=oor)
    order, starts = t_ops.sort_slots(*_t(binned, assign), nodes, 16, child)
    assert t_ops.kernel_launches("histogram_sort") == 0  # CPU: plain
    want_order, want_starts = _numpy_sort(binned, assign, nodes, 16, child)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    # every segment lists its rows in increasing row order
    for t in range(3):
        for f in range(6):
            for s in range(nodes * 16):
                seg = order[t, f, starts[t, f, s]:starts[t, f, s + 1]]
                assert bool((seg[1:] > seg[:-1]).all())
    if oor:
        node = assign // 2 if child else assign
        # a bin past B in node 0 lands in node 1 (bin - B), and is kept
        t, row = np.argwhere((node == 0) & (binned[:, -1] == 16)[None])[0]
        seg = order[t, -1, starts[t, -1, 16]:starts[t, -1, 17]].numpy()
        assert row in seg
        # an id below 0 or past nodes * B is in no segment of its tree
        t, row = np.argwhere(node < 0)[0]
        assert row not in order[t, 0, :starts[t, 0, -1]].numpy()


def test_sort_plain_staged_ids():
    binned, _, _, _, assign = _inputs(21, 2000, 5, 16, 3, 1,
                                      out_of_range=True)
    ids = assign[0][:, None] * 16 + binned
    order, starts = t_ops.sort_slots(*_t(ids), None, 3, 16)
    want = _numpy_sort(binned, assign, 3, 16, False)
    np.testing.assert_array_equal(order.numpy(), want[0])
    np.testing.assert_array_equal(starts.numpy(), want[1])


def walk_model(order: torch.Tensor, starts: torch.Tensor,
               stats: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Step 4 of the kernel on the CPU: every slot's accumulator starts at
    +0 and adds the stats of its segment's rows one at a time, in segment
    order (``reverse``: from the segment's end), in float32 (all slots
    advance together, one position a step).  order (T, d, n), starts (T, d,
    S + 1), stats (T, n, C) -> (T, d, S, C)."""
    n_trees, d, _ = order.shape
    n_slots = starts.shape[-1] - 1
    c = stats.shape[-1]
    begin = starts[..., :-1].long()
    length = (starts[..., 1:] - starts[..., :-1]).long()
    acc = torch.zeros((n_trees, d, n_slots, c), dtype=torch.float32)
    for r in range(int(length.max()) if length.numel() else 0):
        active = length > r
        at = begin + length - 1 - r if reverse else begin + r
        pos = torch.where(active, at, torch.zeros_like(begin))
        rows = torch.gather(order.long(), 2, pos).clamp(min=0)
        vals = torch.gather(stats, 1, rows.reshape(
            n_trees, d * n_slots, 1).expand(-1, -1, c))
        acc = torch.where(active[..., None],
                          acc + vals.reshape(n_trees, d, n_slots, c), acc)
    return acc


def kernel_model(binned, g, h, w, assign, num_nodes, num_bins, child,
                 reverse=False):
    """Steps 1-4: the sort's plain version, then the ordered walk; the
    stats formed as the kernel forms them (child mode: weight 0 for odd
    ``assign``) -> (T, nodes, d, B, 2K+1)."""
    order, starts = t_ref.sort_slots_ref(binned, assign, num_nodes,
                                         num_bins, child)
    if child:
        w = w * (1 - (assign % 2)).to(w.dtype)
    stats = t_hist.stack_stats(g, h, w)                    # (T, n, 2K+1)
    acc = walk_model(order, starts, stats, reverse)
    n_trees, d = acc.shape[:2]
    return acc.reshape(n_trees, d, num_nodes, num_bins, -1).permute(
        0, 2, 1, 3, 4).contiguous()


def _jax_per_tree(binned, g, h, w, assign, num_nodes, num_bins, child):
    fn = j_hist.compute_histogram
    if child:
        fn = j_hist.as_child_fn(fn)
    return np.stack([
        np.asarray(fn(*map(jnp.asarray, (binned, g, h, w_t, a_t)),
                      num_nodes, num_bins))
        for w_t, a_t in zip(w, assign)])


@pytest.mark.parametrize("nodes,child,k,oor", [
    (1, False, 1, False), (2, False, 1, False), (4, False, 1, False),
    (1, True, 1, False), (2, True, 1, False),
    (2, False, 3, False), (2, True, 1, True),
], ids=["level0", "level1-direct", "level2-direct", "level1-child",
        "level2-child", "K3", "oor"])
def test_kernel_model_equals_plain_and_jax(nodes, child, k, oor):
    n_ids = 2 * nodes if child else nodes
    binned, g, h, w, assign = _inputs(22 + nodes + 3 * k, N, D, B, n_ids, T,
                                      k=k, out_of_range=oor)
    tb, tg, th, tw, ta = _t(binned, g, h, w, assign)
    got = kernel_model(tb, tg, th, tw, ta, nodes, B, child)
    plain = t_ref.histogram_round_ref(tb, ta, tg, th, tw, nodes, B, child)
    assert torch.equal(got, plain)
    want = _jax_per_tree(binned, g if k > 1 else g[:, 0],
                         h if k > 1 else h[:, 0], w, assign, nodes, B, child)
    assert torch.equal(got, torch.from_numpy(want))
    if nodes == 1 and not child:
        # the order is what makes the bits: the same rows summed from each
        # segment's end do not give them
        assert not torch.equal(kernel_model(tb, tg, th, tw, ta, nodes, B,
                                            child, reverse=True), plain)
