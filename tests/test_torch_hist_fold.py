"""One histogram launch a level for every (party, shard) block
(``federation.aggregator._local_histograms``), held against the per-block
loop kept here as the oracle: ``base_fn`` on each (party, shard) block, cut
as its own contiguous tensor from the table, the shard partials summed in
shard order 0..S-1 (``mesh_roles.shard_sum``) and the parties side by side.
Everything bit for bit (``torch.equal``):

* each aggregation's provider (the histogram exchange, the argmax storage,
  the q8 transport with fixed draws) over (P, S) in {(1, 1), (4, 1), (4, 3),
  (10, 16)}, n not a multiple of S (weight-0 pad rows), the direct and the
  child form at levels 0-2 and at a compacted level, K = 1 and K = 3; the
  meter's records and the ``federation.hist_blocks`` counter;
* the federated table holds the caller's tensor and answers its (shard,
  party) blocks as views;
* the ids fed to the fold stay in range on compacted depth-4 builds;
* a shared root (``root_delta_rows``) makes one full-width call a shard;
* whole trainings of the ``vfl-*`` backends equal the oracle's;
* on the card (``cuda``), the grid's shape: 150,000 x 10, 10 parties x 16
  shards, 5 trees, one launch a level equal to the 160 block launches.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import boosting
from repro_torch.core.histogram import histogram_dispatch
from repro_torch.core.types import TreeConfig
from repro_torch.federation import aggregator, compress, mesh_roles
from repro_torch.kernels.histogram import ops
from repro_torch.obs import trace as trace_mod

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

DIRECT = histogram_dispatch("cuda-fused-round")
CHILD = histogram_dispatch("cuda-fused-round-child")
NUM_BINS = 8
T = 3


def per_block(base_fn, table, g, h, weight, assign, num_nodes, num_bins,
              kw, child=False):
    """The oracle: one ``base_fn`` call per (party, shard) block on its own
    rows and columns, each block a contiguous copy of the table's rows and
    columns, the shard partials summed in shard order."""
    parties = table.parties
    per_shard = [
        [base_fn(table.table[rows, parties.columns(p)].contiguous(), g[rows],
                 h[rows], weight[:, rows], assign[:, rows], num_nodes,
                 num_bins, **kw) for p in range(parties.num_parties)]
        for rows in table.rows]
    return [mesh_roles.shard_sum(parts) for parts in zip(*per_shard)]


@contextlib.contextmanager
def oracle_installed():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aggregator, "_local_histograms", per_block)
        yield


def make_table(binned, parties, shards):
    """The federated table as ``vfl``'s forest build makes it from the
    padded rows."""
    return mesh_roles.FederatedTable.of(
        binned, mesh_roles.PartyLayout(parties, binned.shape[1]),
        mesh_roles.DataLayout(shards))


def inputs(parties, shards, k, seed=0):
    """(table, g, h, weight): n rows, not a multiple of S, padded with
    weight-0 rows; one column a party at 10 parties (the grid), else two;
    0/1 sample masks with a few fractional weights."""
    rng = np.random.default_rng(seed)
    d = parties * (1 if parties >= 10 else 2)
    n = 13 * shards + (5 if shards > 1 else 0) + 40
    n_pad = -(-n // shards) * shards
    binned = torch.from_numpy(
        rng.integers(0, NUM_BINS, (n_pad, d)).astype(np.int32))
    gshape = (n_pad,) if k == 1 else (n_pad, k)
    g = torch.from_numpy(rng.normal(size=gshape).astype(np.float32))
    h = torch.from_numpy(rng.random(gshape).astype(np.float32))
    w = (rng.random((T, n_pad)) < 0.7).astype(np.float32)
    w[rng.random((T, n_pad)) < 0.1] = 0.375
    w[:, n:] = 0.0
    g[n:] = 0.0
    h[n:] = 0.0
    return make_table(binned, parties, shards), g, h, torch.from_numpy(w)


def level_cases(n, seed=1):
    """(name, child, level, num_nodes, assign, weight factor): the direct
    form at levels 0 and 2, the child form (child slots of ``num_nodes``
    parents) at levels 1 and 2, and a compacted level (``max_active_nodes``
    2: dead rows at the trash slot clamped to the last one, weight 0)."""
    rng = np.random.default_rng(seed)

    def ids(high):
        return torch.from_numpy(
            rng.integers(0, high, (T, n)).astype(np.int32))

    slot = ids(3)                       # 2 = the trash slot
    return [
        ("level0", False, 0, 1, ids(1), None),
        ("level1-child", True, 1, 1, ids(2), None),
        ("level2-child", True, 2, 2, ids(4), None),
        ("level2-direct", False, 2, 4, ids(4), None),
        ("level2-compacted", False, 2, 2, torch.clamp(slot, max=1),
         (slot < 2).to(torch.float32)),
    ]


def fixed_draws(level, num_nodes, party, shape):
    gen = torch.Generator().manual_seed(1000 * level + 10 * num_nodes + party)
    return torch.rand(shape, generator=gen)


def provider(aggregation, child, meter):
    base = CHILD if child else DIRECT
    if aggregation == "histogram":
        return aggregator.federated_round_histogram_fn(base, meter,
                                                       child=child)
    if aggregation == "argmax":
        return aggregator.local_round_histogram_fn(base, child)
    return compress.quantized_round_histogram_fn(
        compress.Q8, meter, base, draws=fixed_draws, child=child)


@pytest.mark.parametrize("aggregation", ["histogram", "argmax", "q8"])
@pytest.mark.parametrize("parties,shards", [(1, 1), (4, 1), (4, 3),
                                            (10, 16)])
def test_folded_provider_equals_per_block(parties, shards, aggregation):
    for k in (1, 3):
        table, g, h, w = inputs(parties, shards, k)
        for name, child, level, nodes, assign, factor in level_cases(
                g.shape[0]):
            weight = w if factor is None else w * factor
            args = (table, g, h, weight, assign, nodes, NUM_BINS)
            meter, want_meter = compress.MessageMeter(), \
                compress.MessageMeter()
            tracer = trace_mod.Tracer()
            with trace_mod.use(tracer):
                got = provider(aggregation, child, meter)(*args, level=level)
            with oracle_installed():
                want = provider(aggregation, child, want_meter)(
                    *args, level=level)
            what = f"K={k} {name}"
            assert got.shape == (T, nodes, table.table.shape[1],
                                 NUM_BINS, 2 * k + 1), what
            assert torch.equal(got, want), what
            assert meter.entries == want_meter.entries, what
            assert [(c, v) for c, _, v in tracer.counters] == [
                ("federation.hist_blocks", {"blocks": parties * shards})
            ], what


@pytest.mark.parametrize("shards", [1, 3])
def test_table_holds_views_not_copies(shards):
    """The table is the caller's (padded) tensor, no copy; ``row_shard`` is
    each row's shard, made once per forest build (none on one shard); each
    (shard, party) block is a view of the table equal to ``binned[rows,
    cols]``."""
    binned = torch.arange(6 * 4, dtype=torch.int32).reshape(6, 4)
    table = make_table(binned, 2, shards)
    assert table.table is binned
    if shards == 1:
        assert table.row_shard is None
    else:
        assert table.row_shard.tolist() == [0, 0, 1, 1, 2, 2]
        assert table.row_shard.dtype == torch.int32
    m = 6 // shards
    assert table.rows == tuple(slice(s * m, (s + 1) * m)
                               for s in range(shards))
    for s in range(shards):
        blocks = table.blocks(s)
        assert len(blocks) == 2
        for p, block in enumerate(blocks):
            assert block.untyped_storage().data_ptr() == \
                binned.untyped_storage().data_ptr()
            assert torch.equal(block,
                               binned[s * m:(s + 1) * m, 2 * p:2 * p + 2])


def small_job(n=301, d=8, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.normal(size=n) + x[:, 0] - x[:, 5] > 0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("subtraction", [True, False])
def test_fold_ids_in_range_on_compacted_depth4(subtraction):
    """Every id the build feeds the fold is in ``[0, num_nodes)`` (child
    form: ``[0, 2 * num_parents)``) on a compacted depth-4 build over 3
    shards, so no id can land in the next shard's nodes; the trees equal
    the per-block oracle's."""
    x, y = small_job()
    tree = TreeConfig(max_depth=4, num_bins=16, max_active_nodes=2,
                      hist_subtraction=subtraction)
    cfg = boosting.dynamic_fedgbf_config(rounds=3, tree=tree)
    seen = []
    fold = aggregator._local_histograms

    def checking(base_fn, table, g, h, weight, assign, num_nodes, num_bins,
                 kw, child=False):
        seen.append((int(assign.min()), int(assign.max()),
                     (2 if child else 1) * num_nodes, child))
        return fold(base_fn, table, g, h, weight, assign, num_nodes,
                    num_bins, kw, child)

    def train():
        return boosting.train_fedgbf(x, y, cfg, device="cpu",
                                     backend=backend_mod.get_backend(
                                         "vfl-histogram-sharded", tree=tree,
                                         num_parties=4, data_shards=3))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aggregator, "_local_histograms", checking)
        model, hist = train()
    assert len(seen) == tree.max_depth * cfg.rounds
    assert any(child for *_, child in seen) == subtraction
    for lo, hi, end, _ in seen:
        assert 0 <= lo and hi < end, (lo, hi, end)
    with oracle_installed():
        want, want_h = train()
    for a, b in zip(model.forests, want.forests):
        for f in ("feature", "threshold", "gain", "leaf_weight"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(hist.final_margin, want_h.final_margin)


@pytest.mark.parametrize("parties,shards", [(4, 1), (4, 3), (10, 16)])
def test_shared_root_one_call_per_shard(parties, shards):
    """Level 0 with ``root_delta_rows`` (shared − delta, which ignores
    ``assign``) makes one full-width call per shard, not one per (party,
    shard) block, records no fold, and equals the per-block oracle."""
    table, g, h, w = inputs(parties, shards, 1)
    w = (w > 0.5).to(torch.float32)          # the shared root takes 0/1 masks
    assign = torch.zeros(w.shape, dtype=torch.int32)
    calls = []

    def counting(*args, **kw):
        calls.append(tuple(args[0].shape))
        return DIRECT(*args, **kw)

    meter, want_meter = compress.MessageMeter(), compress.MessageMeter()
    tracer = trace_mod.Tracer()
    args = (table, g, h, w, assign, 1, NUM_BINS)
    with trace_mod.use(tracer):
        got = aggregator.federated_round_histogram_fn(counting, meter)(
            *args, level=0, root_delta_rows=7)
    n_pad, d = table.table.shape
    assert calls == [(n_pad // shards, d)] * shards
    assert tracer.counters == []
    with oracle_installed():
        want = aggregator.federated_round_histogram_fn(DIRECT, want_meter)(
            *args, level=0, root_delta_rows=7)
    assert torch.equal(got, want)
    assert meter.entries == want_meter.entries


@pytest.mark.parametrize("name", [
    "vfl-histogram", "vfl-histogram-sharded", "vfl-histogram-q8-sharded",
    "vfl-argmax-topk-sharded", "vfl-histogram-async-q16-sharded-chaos"])
def test_training_equals_per_block_oracle(name):
    """Three rounds of each backend: trees, leaves, margins and the metered
    bytes equal the run with the per-block oracle, bit for bit."""
    x, y = small_job()
    tree = TreeConfig(max_depth=3, num_bins=16)
    cfg = boosting.dynamic_fedgbf_config(rounds=3, tree=tree)
    kw = {"data_shards": 3} if "sharded" in name else {}

    def train():
        meter = compress.MessageMeter()
        model, hist = boosting.train_fedgbf(
            x, y, cfg, device="cpu", backend=backend_mod.get_backend(
                name, tree=tree, num_parties=4, meter=meter, **kw))
        return model, hist, meter.phase_totals()

    model, hist, wire = train()
    with oracle_installed():
        want, want_h, want_wire = train()
    for a, b in zip(model.forests, want.forests):
        for f in ("feature", "threshold", "gain", "leaf_weight"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(hist.final_margin, want_h.final_margin)
    assert wire == want_wire


@pytest.fixture
def device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA not available)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_grid_fold_on_card_equals_block_launches(device):
    """The grid's shape on the card: 150,000 x 10 (one column a party), 10
    parties x 16 shards, 5 trees, subtraction on (direct at level 0, child
    at levels 1-2): each level is one launch, ``torch.equal`` to the 160
    block launches' shard sums."""
    parties, shards, trees, n = 10, 16, 5, 150_000
    gen = torch.Generator().manual_seed(0)
    binned = torch.randint(0, 32, (n, parties), generator=gen,
                           dtype=torch.int32)
    g = torch.randn(n, generator=gen)
    h = torch.rand(n, generator=gen)
    w = (torch.rand((trees, n), generator=gen) < 0.1).to(torch.float32)
    table = make_table(binned.to(device), parties, shards)
    g, h, w = g.to(device), h.to(device), w.to(device)
    for level, (child, nodes) in enumerate([(False, 1), (True, 1),
                                            (True, 2)]):
        high = 2 * nodes if child else nodes
        assign = torch.randint(0, high, (trees, n), generator=gen,
                               dtype=torch.int32).to(device)
        args = (table, g, h, w, assign, nodes, 32)
        fn = aggregator.federated_round_histogram_fn(
            CHILD if child else DIRECT, child=child)
        ops.reset_launches()
        got = fn(*args, level=level)
        torch.cuda.synchronize()
        assert ops.kernel_launches("histogram_round") == 1, level
        with oracle_installed():
            want = aggregator.federated_round_histogram_fn(
                CHILD if child else DIRECT)(*args, level=level)
        torch.cuda.synchronize()
        assert ops.kernel_launches("histogram_round") == 1 + parties * shards
        assert torch.equal(got, want), level
