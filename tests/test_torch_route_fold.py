"""One routing pass a level for every (party, shard) block
(``federation.aggregator.federated_round_route_fn``), held against the
block loop kept here as the oracle: each data shard's rows, each party's
block of them read at its own columns, one
bit-packed map a (party, shard) block, each shard's maps summed over the
parties.  Everything bit for bit (``torch.equal``):

* the router over (P, S) in {(1, 1), (4, 1), (4, 3), (10, 16)}, n not a
  multiple of S (weight-0 pad rows), T = 1 and 3, levels 0-2 with unsplit
  nodes (feature -1) and a compacted level (threshold ``num_bins``,
  feature -1 on the dead slots): the assignment, the centralized
  traversal's too, the meter's ``id_partition`` records and the
  ``federation.route_blocks`` counter;
* the router's aten ops: as many at (10, 16) as at (1, 1), none of them
  a tensor made from host data once the layout's lookup exists;
* ``PartyLayout.owner``, the one lookup a layout and device;
* whole trainings of the ``vfl-*`` backends equal the oracle's, and a
  ``vfl-histogram-sharded`` one on 4 parties x 3 shards the centralized
  ``local-cuda`` one (features and thresholds exact; leaves and margins at
  the sharded tests' tolerance: the shard partials sum in shard order);
* on the card (``cuda``), the grid's shape: 150,000 x 10, 10 parties x 16
  shards, 5 trees, the real decisions of a depth-3 build, each level's
  routing equal to the block loop's.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import backend as backend_mod
from repro_torch.core import boosting, forest, prng
from repro_torch.core import tree as tree_mod
from repro_torch.core.split import SplitDecision
from repro_torch.core.types import TreeConfig
from repro_torch.federation import aggregator, compress, mesh_roles
from repro_torch.obs import trace as trace_mod

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

NUM_BINS = 8
RTOL, ATOL = 1e-5, 1e-6
BLOCKS = [(1, 1), (4, 1), (4, 3), (10, 16)]


def block_loop(meter=None):
    """The oracle: the router a (party, shard) block at a time, each party
    reading its own block at its local columns, one ``pack_bits`` a block,
    one record of party 0's S maps, each shard's maps summed over the
    parties, the shards' decisions concatenated."""

    def fn(table, assign, decision):
        node = assign.long()
        f_global = torch.gather(decision.feature, 1, node)
        thr = torch.gather(decision.threshold, 1, node)
        shard_maps = []
        for s, rows in enumerate(table.rows):
            fg, tr = f_global[:, rows], thr[:, rows]
            maps = []
            for p, block in enumerate(table.blocks(s)):
                cols = table.parties.columns(p)
                f_local = fg - cols.start
                owned = (f_local >= 0) & (f_local < block.shape[1])
                col = f_local.clamp(0, block.shape[1] - 1).long()
                fv = torch.gather(block, 1, col.T).T
                maps.append(aggregator.pack_bits(owned & (fv > tr)))
            shard_maps.append(maps)
        if meter is not None:
            meter.record("id_partition",
                         torch.stack([maps[0] for maps in shard_maps]))
        go_right = [
            aggregator.unpack_bits(torch.sum(torch.stack(maps), dim=0,
                                             dtype=torch.uint8),
                                   rows.stop - rows.start)
            for rows, maps in zip(table.rows, shard_maps)]
        return assign * 2 + torch.cat(go_right, dim=1)

    return fn


@contextlib.contextmanager
def oracle_installed():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aggregator, "federated_round_route_fn", block_loop)
        yield


def make_table(binned, parties, shards):
    return mesh_roles.FederatedTable.of(
        binned, mesh_roles.PartyLayout(parties, binned.shape[1]),
        mesh_roles.DataLayout(shards))


def table_for(parties, shards, seed=0):
    """n rows, not a multiple of S, padded; one column a party at 10
    parties (the grid), else two."""
    rng = np.random.default_rng(seed)
    d = parties * (1 if parties >= 10 else 2)
    n = 13 * shards + (5 if shards > 1 else 0) + 40
    n_pad = -(-n // shards) * shards
    return make_table(torch.from_numpy(
        rng.integers(0, NUM_BINS, (n_pad, d)).astype(np.int32)),
        parties, shards)


def level_cases(t, n, d, seed=1):
    """(name, assign, decision) at levels 0-2: every node split, a third of
    them unsplit (feature -1), and a compacted level (slots past the live
    ones: feature -1, threshold ``num_bins``)."""
    rng = np.random.default_rng(seed)

    def ints(low, high, shape):
        return torch.from_numpy(rng.integers(low, high, shape)
                                .astype(np.int32))

    cases = []
    for level in range(3):
        width = 2 ** level
        assign = ints(0, width, (t, n))
        feature = ints(0, d, (t, width))
        threshold = ints(0, NUM_BINS, (t, width))
        gain = torch.ones(t, width)
        cases.append((f"level{level}", assign,
                      SplitDecision(feature, threshold, gain)))
        unsplit = torch.from_numpy(rng.random((t, width)) < 1 / 3)
        cases.append((f"level{level}-unsplit", assign, SplitDecision(
            torch.where(unsplit, -1, feature), threshold, gain)))
    dead = torch.arange(4) >= 2                  # two live slots of four
    cases.append(("level2-compacted", ints(0, 4, (t, n)), SplitDecision(
        torch.where(dead, -1, ints(0, d, (t, 4))),
        torch.where(dead, NUM_BINS, ints(0, NUM_BINS, (t, 4))),
        torch.where(dead, 0.0, 1.0).expand(t, 4))))
    return cases


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("parties,shards", BLOCKS)
def test_folded_router_equals_block_loop(parties, shards, t):
    table = table_for(parties, shards)
    n, d = table.table.shape
    for name, assign, decision in level_cases(t, n, d):
        meter, want_meter = compress.MessageMeter(), compress.MessageMeter()
        tracer = trace_mod.Tracer()
        with trace_mod.use(tracer):
            got = aggregator.federated_round_route_fn(meter)(
                table, assign, decision)
        want = block_loop(want_meter)(table, assign, decision)
        assert got.dtype == torch.int32, name
        assert torch.equal(got, want), name
        assert torch.equal(got, tree_mod.route_local_round(
            table.table, assign, decision)), name
        m = n // shards
        assert meter.entries == want_meter.entries == [
            {"phase": "id_partition", "nbytes": shards * t * (-(-m // 8))}
        ], name
        assert [(c, v) for c, _, v in tracer.counters] == [
            ("federation.route_blocks", {"blocks": parties * shards})], name


#: view ops that name one step differently as the shapes change
VIEWS = {"alias": "slice"}


class OpLog(TorchDispatchMode):
    """Every aten op dispatched inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_router_ops_do_not_grow_with_blocks():
    """The same aten ops route 1 block and 160: no per-block loop; and once
    the layout's lookup exists, a call makes no tensor from host data (on
    the card, no host-to-device copy)."""
    logs = {}
    for parties, shards in BLOCKS:
        table = table_for(parties, shards)
        n, d = table.table.shape
        _, assign, decision = level_cases(3, n, d)[4]       # level 2
        route = aggregator.federated_round_route_fn(compress.MessageMeter())
        route(table, assign, decision)                      # the lookup
        with OpLog() as log:
            route(table, assign, decision)
        logs[parties, shards] = log.ops
    first = logs[BLOCKS[0]]
    for ops in logs.values():
        # a shard's m a multiple of 8 or not: the unpacked bits' last view
        # is an alias or a slice
        assert [VIEWS.get(op, op) for op in ops] == \
            [VIEWS.get(op, op) for op in first], logs
    assert len(first) < 40, first
    assert "lift_fresh" not in first, first


@pytest.mark.parametrize("parties,d", [(1, 3), (4, 8), (10, 10)])
def test_party_layout_owner(parties, d):
    """``owner`` answers each column's party (``party_index``) and -1 for
    -1, in the input's shape, from one lookup a layout and device."""
    layout = mesh_roles.PartyLayout(parties, d)
    feature = torch.tensor([[-1] + list(range(d)), [d - 1] * (d + 1)],
                           dtype=torch.int32)
    got = layout.owner(feature)
    assert got.shape == feature.shape
    assert got.tolist() == [[-1] + [layout.party_index(f) for f in range(d)],
                            [parties - 1] * (d + 1)]
    lut = layout._owners[feature.device]
    layout.owner(feature.long())
    assert layout._owners == {feature.device: lut}


def small_job(n=301, d=8, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.normal(size=n) + x[:, 0] - x[:, 5] > 0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name", [
    "vfl-histogram", "vfl-histogram-sharded", "vfl-argmax-topk-sharded",
    "vfl-histogram-q8-sharded", "vfl-histogram-async-q16-sharded-chaos"])
def test_training_equals_block_loop_oracle(name):
    """Three rounds of each backend on 4 parties (x 3 shards): trees,
    leaves, margins and the metered bytes equal the run with the block
    loop, bit for bit."""
    x, y = small_job()
    tree = TreeConfig(max_depth=3, num_bins=16)
    cfg = boosting.dynamic_fedgbf_config(rounds=3, tree=tree)
    kw = {"data_shards": 3} if "sharded" in name else {}

    def train():
        meter = compress.MessageMeter()
        model, hist = boosting.train_fedgbf(
            x, y, cfg, device="cpu", backend=backend_mod.get_backend(
                name, tree=tree, num_parties=4, meter=meter, **kw))
        return model, hist, meter.phase_totals(), meter.phase_counts()

    model, hist, wire, counts = train()
    with oracle_installed():
        want, want_h, want_wire, want_counts = train()
    for a, b in zip(model.forests, want.forests):
        for f in ("feature", "threshold", "gain", "leaf_weight"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(hist.final_margin, want_h.final_margin)
    assert wire == want_wire
    assert counts == want_counts


def test_sharded_training_equals_local_cuda():
    """``vfl-histogram-sharded`` on 4 parties x 3 shards against the
    centralized ``local-cuda`` run (its plain version here) on the same
    masks: features and thresholds exact, leaves and margins at the
    sharded tests' tolerance."""
    x, y = small_job(n=509)
    tree = TreeConfig(max_depth=3, num_bins=16)
    cfg = boosting.dynamic_fedgbf_config(rounds=3, tree=tree)
    masks = forest.draw_step_masks(cfg, x.shape[0], x.shape[1],
                                   prng.PRNGKey(0))
    local, local_h = boosting.train_fedgbf(x, y, cfg, masks=masks,
                                           backend="local-cuda",
                                           device="cpu")
    model, hist = boosting.train_fedgbf(
        x, y, cfg, masks=masks, device="cpu",
        backend=backend_mod.get_backend("vfl-histogram-sharded", tree=tree,
                                        num_parties=4, data_shards=3))
    for a, b in zip(model.forests, local.forests):
        assert torch.equal(a.feature, b.feature)
        assert torch.equal(a.threshold, b.threshold)
        torch.testing.assert_close(a.leaf_weight, b.leaf_weight, rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(hist.final_margin, local_h.final_margin,
                               rtol=RTOL, atol=ATOL)


@pytest.fixture
def device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA not available)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_grid_router_on_card_equals_block_loop(device):
    """The grid's shape on the card: 150,000 x 10 (one column a party), 10
    parties x 16 shards, 5 trees; a depth-3 forest build's own decisions
    at every level: the folded router's assignment and ``id_partition``
    bytes equal the block loop's."""
    parties, shards, trees, n = 10, 16, 5, 150_000
    gen = torch.Generator().manual_seed(0)
    binned = torch.randint(0, 32, (n, parties), generator=gen,
                           dtype=torch.int32)
    g = torch.randn(n, generator=gen) + (binned[:, 3] > 12).float() - \
        (binned[:, 7] < 9).float()
    h = torch.rand(n, generator=gen) + 0.1
    smask = (torch.rand((trees, n), generator=gen) < 0.3).to(torch.float32)
    fmask = torch.ones((trees, parties), dtype=torch.bool)
    tree = TreeConfig(max_depth=3, num_bins=32)
    calls = []
    folded = aggregator.federated_round_route_fn

    def capturing(meter=None):
        route = folded(meter)

        def fn(table, assign, decision):
            out = route(table, assign, decision)
            calls.append((table, assign, decision, out))
            return out
        return fn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aggregator, "federated_round_route_fn", capturing)
        backend = backend_mod.get_backend(
            "vfl-histogram-sharded", tree=tree, num_parties=parties,
            data_shards=shards)
    backend.build_forest(*(v.to(device) for v in (binned, g, h, smask,
                                                  fmask)), tree)
    torch.cuda.synchronize()
    assert len(calls) == tree.max_depth
    assert bool((calls[-1][2].feature >= 0).any())      # a real level 2
    for level, (table, assign, decision, got) in enumerate(calls):
        meter, want_meter = compress.MessageMeter(), compress.MessageMeter()
        again = folded(meter)(table, assign, decision)
        want = block_loop(want_meter)(table, assign, decision)
        torch.cuda.synchronize()
        assert torch.equal(got, want), level
        assert torch.equal(again, want), level
        assert meter.entries == want_meter.entries == [
            {"phase": "id_partition",
             "nbytes": shards * trees * 1_172}], level
