"""Port vs JAX package: the wire-byte ledger of vertically federated
training (CPU, plain arithmetic and dry forest builds; no JAX program).

* The port's dry probe (``compress.probe_tree_cost``: one T = 1 forest
  build on zero inputs, read off a ``MessageMeter``) gives per-tree phase
  bytes that the JAX ``protocol.ProtocolLedger.record_run`` reconciles
  exactly (delta 0 on every phase), and so does the port's own ledger;
* the port's ``ProtocolLedger.breakdown()`` equals the JAX one for the same
  spec: raw, q8 and top-k, K in {1, 3}, subtraction on and off;
* the round engine's contract: one histogram record per level whatever T
  (two under quantization), the async exchange included
  (``selftest.check_round_collective_counts``);
* a whole run's own meter agrees with the ledger the dry probe feeds.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import types as j_types
from repro.federation import chaos as j_chaos
from repro.federation import compress as j_compress
from repro.federation import protocol as j_protocol
from repro_torch.core import backend as t_backend
from repro_torch.core import boosting as t_boosting
from repro_torch.core.types import TreeConfig as TTreeConfig
from repro_torch.federation import chaos as t_chaos
from repro_torch.federation import compress as t_compress
from repro_torch.data import synthetic as t_synthetic
from repro_torch.federation import protocol as t_protocol
from torch_parity import jax_config

#: (aggregation, port transport, JAX transport)
TRANSPORTS = {
    "raw": ("histogram", None, None),
    "q8": ("histogram", t_compress.Q8, j_compress.Q8),
    "q16-async": ("histogram", t_compress.Q16, j_compress.Q16),
    "argmax": ("argmax", None, None),
    "topk": ("argmax", t_compress.TOPK, j_compress.TOPK),
}
N, D = 600, 8


def _specs(parties, sub, k, transport):
    agg, t_tr, j_tr = TRANSPORTS[transport]
    tree = TTreeConfig(max_depth=3, num_bins=16, hist_subtraction=sub)
    cfg = t_boosting.dynamic_fedgbf_config(
        rounds=3, tree=tree, loss="softmax3" if k == 3 else "logistic")
    return agg, t_tr, j_tr, tree, cfg


@pytest.mark.parametrize("transport", list(TRANSPORTS))
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("sub", [True, False])
def test_probe_reconciles_and_breakdown_equals_jax(transport, k, sub):
    parties = 4
    agg, t_tr, j_tr, tree, cfg = _specs(parties, sub, k, transport)
    asyn = transport.endswith("async")
    ledger = t_compress.reconciled_ledger(
        parties, tree, cfg, aggregation=agg, transport=t_tr, n_samples=N,
        num_features=D, async_exchange=asyn, n_channels=k)
    rec = ledger.reconcile()
    assert all(v["match"] and v["delta"] == 0 for v in rec.values()), rec
    assert rec["total"]["measured"] > 0

    per_tree, grad = t_compress.probe_tree_cost(
        parties, tree, aggregation=agg, transport=t_tr, n_samples=N,
        num_features=D, async_exchange=asyn, n_channels=k)
    j_cfg = jax_config(cfg)
    spec_kw = dict(n_samples=N, party_dims=(D // parties,) * parties,
                   num_bins=tree.num_bins, max_depth=tree.max_depth,
                   aggregation=agg, hist_subtraction=sub, n_channels=k)
    j_ledger = j_protocol.ProtocolLedger(
        spec=j_protocol.ProtocolSpec(**spec_kw), cfg=j_cfg, transport=j_tr)
    j_ledger.record_run(per_tree, grad)
    j_rec = j_ledger.reconcile()
    assert all(v["match"] for v in j_rec.values()), j_rec
    assert j_rec == rec
    assert ledger.breakdown() == j_ledger.breakdown()
    assert ledger.per_round_measured() == j_ledger.per_round_measured()
    assert (ledger.predicted_paillier().breakdown()
            == j_ledger.predicted_paillier().breakdown())


@pytest.mark.parametrize("parties", [2, 4])
@pytest.mark.parametrize("n_trees", [1, 3, 5])
@pytest.mark.parametrize("transport", ["raw", "q8", "q16-async"])
def test_round_collective_counts(parties, n_trees, transport):
    """One histogram exchange per level whatever T (int payload + scales
    under quantization), one mask and one routing map per level; the
    histogram bytes scale with T."""
    _, t_tr, _, _, _ = _specs(parties, True, 1, transport)
    tree = TTreeConfig(max_depth=3, num_bins=16)
    rc = t_compress.probe_round_collectives(
        parties, tree, n_trees, transport=t_tr, n_samples=512,
        num_features=parties * 2,
        async_exchange=transport.endswith("async"))
    counts = rc["counts"]
    per_level = 2 if t_tr is not None else 1
    assert counts["histograms"] == per_level * tree.max_depth, counts
    assert counts["feature_mask"] == tree.max_depth, counts
    assert counts["id_partition"] == tree.max_depth, counts
    one = t_compress.probe_round_collectives(
        parties, tree, 1, transport=t_tr, n_samples=512,
        num_features=parties * 2)
    assert rc["totals"]["histograms"] == n_trees * one["totals"][
        "histograms"]
    # the bit-packed routing map: ceil(n / 8) bytes a tree a level
    assert rc["totals"]["id_partition"] == n_trees * 3 * (512 // 8)


def test_wire_model_equals_jax():
    """The copied wire and Paillier models agree with the JAX ones on
    compaction, shards, K and chaos retries (plain arithmetic, no
    probe)."""
    for agg in ("histogram", "argmax"):
        for mx in (0, 2):
            kw = dict(n_samples=1001, party_dims=(3, 3, 3), num_bins=32,
                      max_depth=4, aggregation=agg, hist_subtraction=True,
                      max_active_nodes=mx, data_shards=3, n_channels=3)
            cfg = t_boosting.dynamic_fedgbf_config(rounds=5)
            j_cfg = jax_config(cfg)
            for t_tr, j_tr in ((None, None), (t_compress.Q8, j_compress.Q8),
                               (t_compress.TOPK, j_compress.TOPK)):
                assert t_protocol.wire_run_cost(
                    t_protocol.ProtocolSpec(**kw), cfg, t_tr) == \
                    j_protocol.wire_run_cost(
                        j_protocol.ProtocolSpec(**kw), j_cfg, j_tr)
            assert t_protocol.run_cost(t_protocol.ProtocolSpec(**kw), cfg) \
                == t_protocol.ProtocolCosts(**dataclasses.asdict(
                    j_protocol.run_cost(j_protocol.ProtocolSpec(**kw),
                                        j_cfg)))
    assert isinstance(j_cfg, j_types.FedGBFConfig)
    for agg, t_tr, j_tr in (("histogram", t_compress.Q8, j_compress.Q8),
                            ("argmax", t_compress.TOPK, j_compress.TOPK)):
        t_spec = t_chaos.ChaosSpec(drop=0.2, corrupt=0.1, dup=0.1, seed=5)
        j_spec = j_chaos.ChaosSpec(drop=0.2, corrupt=0.1, dup=0.1, seed=5)
        assert t_protocol.wire_party_tree_cost(
            100, 2, 32, 3, agg, t_tr, chaos=t_spec) == \
            j_protocol.wire_party_tree_cost(100, 2, 32, 3, agg, j_tr,
                                            chaos=j_spec)
    with pytest.raises(ValueError, match="bits"):
        t_compress.TransportSpec(kind="quantized", bits=4)
    assert [t.tag for t in (t_compress.RAW, t_compress.Q8, t_compress.Q16,
                            t_compress.TOPK)] == ["raw", "q8", "q16", "topk"]


@pytest.mark.parametrize("name", ["vfl-histogram", "vfl-histogram-async-q8",
                                  "vfl-argmax-topk"])
def test_run_meter_matches_ledger(name):
    """A whole training run's own meter, scaled by the passive parties
    where the phase is per party, equals the ledger's measured bytes: the
    run exchanged what the dry probe predicts."""
    parties = 4
    ds = t_synthetic.load("default_credit_card", n=600)
    x = np.asarray(ds.x_train)[:, :D]
    tree = TTreeConfig(max_depth=3, num_bins=16)
    cfg = t_boosting.dynamic_fedgbf_config(rounds=3, tree=tree)
    meter = t_compress.MessageMeter()
    bk = t_backend.get_backend(name, tree=tree, num_parties=parties,
                               meter=meter)
    t_boosting.train_fedgbf(x, ds.y_train, cfg, backend=bk, device="cpu")
    desc = bk.descriptor
    ledger = t_compress.reconciled_ledger(
        parties, tree, cfg, aggregation="argmax" if "argmax" in name
        else "histogram", transport=desc.transport_spec,
        n_samples=x.shape[0], num_features=D,
        async_exchange=desc.async_exchange)
    live = meter.phase_totals()
    assert set(live) == {k for k, v in ledger.measured.items() if v}
    for phase, nbytes in live.items():
        mult = (parties - 1 if phase in t_protocol.PER_PASSIVE_PHASES
                else 1)
        assert mult * nbytes == ledger.measured[phase], phase
