"""The traversal kernels' work split, modelled on the CPU.

``ensemble_predict.cu`` takes rows in tiles of ``rows`` with ``lanes``
threads per row, stages the x tile (sanitised, at an odd row stride) and
the trees in chunks of packed (clamped feature, threshold) pairs, buffers
each tree's leaf value per row and then runs the FMA chain in tree order.
``model_sweep`` repeats that index arithmetic in torch, with the sizes
``ops.launch_config`` chooses, and must be ``torch.equal`` to the plain
versions (``ref.py``) at the edges of the split: one row, a tile and a
ragged one, one tree, one tree past the lanes and past a chunk, depth 0
to 12, d = 1 to 4096, NaN and ±inf rows.  ``launch_config`` itself is
held to what the kernel accepts at depth 0-12.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.fma import fma
from repro_torch.kernels.ensemble_predict import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its cases and input generators)

SM_COUNT = 132  # H100 SXM
NUM_BINS = 32


def model_sweep(raw, x, feature, threshold, leaf, scale, max_depth, cfg):
    """The kernel's arithmetic and indexing with the sizes ``cfg``, every
    tile at once: (n,) float32."""
    n, d = x.shape
    n_trees = feature.shape[0]
    rows, lanes, chunk, stride = cfg.rows, cfg.lanes, cfg.chunk, cfg.stride
    n_tiles = -(-n // rows)
    # the blocks' loop over tiles takes each tile once
    taken = sorted(t for b in range(cfg.grid)
                   for t in range(b, n_tiles, cfg.grid))
    assert taken == list(range(n_tiles))
    # the x tile: sanitised as staged, row r at r * stride; rows past n and
    # columns past d are never read
    width = stride if cfg.stage_x else d
    tiles = torch.zeros((n_tiles * rows, width), dtype=x.dtype)
    tiles[:n, :d] = ref.sanitize(x) if raw and cfg.stage_x else x
    tiles = tiles.reshape(n_tiles, rows * width)
    row_base = (torch.arange(rows) * width)[None, :]
    # packed node pairs: the feature clamped, an unsplit node's threshold
    # one that no value exceeds
    never = float("inf") if raw else torch.iinfo(torch.int32).max
    node_f = torch.where(feature < 0, 0, feature.clamp(max=d - 1)).long()
    node_t = torch.where(feature < 0, torch.full_like(threshold, never),
                         threshold)
    n_internal, n_leaves = 2 ** max_depth - 1, 2 ** max_depth

    def walk(s_f, s_t, t):
        idx = torch.zeros((n_tiles, rows), dtype=torch.long)
        for level in range(max_depth):
            node = t * n_internal + 2 ** level - 1 + idx
            v = tiles.gather(1, row_base + s_f[node])
            if raw and not cfg.stage_x:
                v = ref.sanitize(v)
            idx = 2 * idx + (v > s_t[node]).long()
        return idx

    acc = torch.zeros((n_tiles, rows), dtype=torch.float32)
    for t0 in range(0, n_trees, chunk):
        c = min(chunk, n_trees - t0)
        s_f = node_f[t0:t0 + c].reshape(-1)
        s_t = node_t[t0:t0 + c].reshape(-1)
        s_leaf = leaf[t0:t0 + c].reshape(-1)
        if lanes == 1:
            # one thread a row: each tree's leaf chained as it is walked
            for t in range(0, c, 2):
                for tt in sorted({t, min(t + 1, c - 1)}):
                    acc = fma(s_leaf[tt * n_leaves + walk(s_f, s_t, tt)],
                              scale[t0 + tt], acc)
            continue
        s_val = torch.full((n_tiles, c * rows), float("nan"))
        written = [0] * c
        for g in range(lanes):
            for t in range(g, c, 2 * lanes):
                t2 = t + lanes if t + lanes < c else t
                for tt in sorted({t, t2}):
                    s_val[:, tt * rows:(tt + 1) * rows] = s_leaf[
                        tt * n_leaves + walk(s_f, s_t, tt)]
                    written[tt] += 1
        assert written == [1] * c, "every tree of the chunk walked once"
        for t in range(c):
            acc = fma(s_val[:, t * rows:(t + 1) * rows], scale[t0 + t], acc)
    return acc.reshape(-1)[:n]


def _inputs(seed, raw, n, n_trees, depth, d):
    rng = np.random.default_rng(seed)
    t = chip_smoke.random_ensemble(rng, n_trees, depth, d, NUM_BINS, "cpu")
    if raw:
        return (chip_smoke.hard_rows(rng, n, d, "cpu"), t["feature"],
                t["thr_value"], t["leaf"], t["scale"])
    binned = torch.from_numpy(
        rng.integers(0, NUM_BINS, (n, d)).astype(np.int32))
    return binned, t["feature"], t["threshold"], t["leaf"], t["scale"]


# chip_smoke's phase-2a cases that are small enough for the CPU
CASES = [c for c in chip_smoke.traversal_cases()
         if c[0] <= 8192 and c[0] * c[3] <= 8192 * 23]


@pytest.mark.parametrize("sm_count", [SM_COUNT, 1],
                         ids=["132sm", "1sm"])
@pytest.mark.parametrize("raw", [True, False], ids=["raw", "binned"])
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "n{}-T{}-D{}-d{}".format(*c))
def test_model_equals_plain(case, raw, sm_count):
    """On one SM, two tiles of 256 rows already take one thread a row: the
    case then models that path at the same shapes."""
    n, n_trees, depth, d = case
    cfg = ops.launch_config(n, d, n_trees, depth, sm_count)
    args = _inputs(CASES.index(case), raw, n, n_trees, depth, d)
    plain = (ref.predict_forest_raw_ref if raw
             else ref.predict_forest_binned_ref)
    want = plain(*args, depth)
    got = model_sweep(raw, *args, depth, cfg)
    assert torch.equal(got, want)


def test_model_sees_the_tree_order():
    """The chain runs in tree order: the same leaf values chained in
    another order give other bits, so equality above is not by chance."""
    args = _inputs(99, True, 8192, 78, 3, 23)
    x, feature, thr, leaf, scale = args
    want = ref.predict_forest_raw_ref(*args, 3)
    flip = torch.arange(77, -1, -1)
    other = ref.predict_forest_raw_ref(x, feature[flip], thr[flip],
                                       leaf[flip], scale[flip], 3)
    assert not torch.equal(other, want)


@pytest.mark.parametrize("depth", range(13))
def test_launch_config_limits(depth):
    """At every depth the kernel takes and every d up to 4096: a whole
    tree a chunk at least, at most 227 KB of shared memory (the layout's
    bytes exactly), 256 threads, an odd stride, lanes the chunk keeps
    busy, and a grid that covers the tiles within the SMs' residency."""
    n_internal, n_leaves = 2 ** depth - 1, 2 ** depth
    for d in (1, 2, 23, 24, 100, 1023, 4096):
        for n_trees in (1, 2, 7, 8, 9, 78, 300, 5000):
            for n in (1, 255, 8192, 262144):
                cfg = ops.launch_config(n, d, n_trees, depth, SM_COUNT)
                assert cfg.rows * cfg.lanes == ops.THREADS
                assert cfg.unrolled == (depth == ops.UNROLLED_DEPTH)
                assert 1 <= cfg.chunk <= n_trees
                assert cfg.lanes <= cfg.chunk or cfg.lanes == 1
                assert cfg.stride % 2 == 1 and cfg.stride >= d
                tile = cfg.rows * cfg.stride * 4 if cfg.stage_x else 0
                assert tile <= ops.X_TILE_MAX
                s_val = cfg.rows if cfg.lanes > 1 else 0
                assert cfg.smem_bytes == tile + cfg.chunk * (
                    8 * n_internal + 4 * (n_leaves + 1 + s_val))
                assert cfg.smem_bytes <= ops.SMEM_MAX
                if cfg.chunk > 1:
                    assert cfg.smem_bytes <= ops.SMEM_DEFAULT
                n_tiles = -(-n // cfg.rows)
                assert 1 <= cfg.grid <= n_tiles
                assert cfg.grid <= SM_COUNT * 8
                if -(-n // ops.THREADS) >= 2 * SM_COUNT:
                    assert (cfg.rows, cfg.lanes) == (256, 1)


def test_launch_config_serving_shape():
    """8192 x 23, 78 trees of depth 3: 32-row tiles, 8 lanes, one chunk,
    the depth-3 instance, 256 tiles each its own block."""
    cfg = ops.launch_config(8192, 23, 78, 3, SM_COUNT)
    assert (cfg.rows, cfg.lanes, cfg.chunk, cfg.stride, cfg.stage_x,
            cfg.unrolled) == (32, 8, 78, 23, True, True)
    assert ops.launch_config(8192, 23, 78, 3, SM_COUNT,
                             unrolled=False) == cfg._replace(unrolled=False)
    assert cfg.grid == 256
    assert cfg.smem_bytes == 32 * 23 * 4 + 78 * (7 * 8 + 4 * (8 + 1 + 32))


def test_launch_config_large_batch():
    """262,144 x 23: 1,024 tiles of 256 rows, one thread a row (no leaf
    buffer), 30,728 B a block.  The grid is the blocks the SMs hold as the
    residency function says: shared memory alone allows 7 an SM, and where
    registers allow fewer (the occupancy calculator on the card), the grid
    shrinks with them."""
    cfg = ops.launch_config(1 << 18, 23, 78, 3, SM_COUNT)
    assert (cfg.rows, cfg.lanes, cfg.chunk, cfg.stage_x) == (256, 1, 78,
                                                              True)
    assert cfg.smem_bytes == 256 * 23 * 4 + 78 * (7 * 8 + 4 * (8 + 1))
    assert ops.smem_residency(cfg) == 7
    assert cfg.grid == SM_COUNT * 7
    seen = []

    def four(asked):
        seen.append(asked)
        return 4

    held = ops.launch_config(1 << 18, 23, 78, 3, SM_COUNT, residency=four)
    assert seen == [cfg._replace(grid=0)]
    assert held == cfg._replace(grid=SM_COUNT * 4)


@pytest.mark.parametrize("n, lanes", [
    (ops.THREADS * (2 * SM_COUNT - 1), 8),
    (ops.THREADS * (2 * SM_COUNT - 1) + 1, 1),
    (1 << 15, 8), (1 << 16, 8), (3 << 15, 1), (1 << 18, 1)])
def test_launch_config_one_thread_a_row_from_two_tiles_an_sm(n, lanes):
    """One thread a row from the batch whose 256-row tiles give every SM
    two (``chip_smoke.py`` times both choices at 65,536 and 98,304 rows,
    either side of the cut); smaller batches keep 8 threads a row."""
    assert ops.launch_config(n, 23, 78, 3, SM_COUNT).lanes == lanes


@pytest.mark.parametrize("lanes", [1, 2, 8])
def test_launch_config_lanes_override(lanes):
    """``lanes`` replaces the batch-size rule (``chip_smoke`` times both
    choices at each size); the model of the split stays equal to the plain
    version with it."""
    cfg = ops.launch_config(8192, 23, 78, 3, SM_COUNT, lanes=lanes)
    assert (cfg.rows, cfg.lanes) == (ops.THREADS // lanes, lanes)
    args = _inputs(7, True, 300, 78, 3, 23)
    cfg = ops.launch_config(300, 23, 78, 3, SM_COUNT, lanes=lanes)
    assert torch.equal(model_sweep(True, *args, 3, cfg),
                       ref.predict_forest_raw_ref(*args, 3))
