"""Federated-vs-centralized self-checks of the port: the counterpart of
``repro/federation/selftest.py``, with its checks' names and tolerances.

    PYTHONPATH=src python -m repro_torch.federation.selftest [--device cpu]

The oracle is the port's own centralized builder (``forest.build_forest``
with the plain providers, or ``train_fedgbf(backend="local")``), on the
same device.  The parties are column blocks and the data shards row blocks
of one process (``mesh_roles``), so the lattice needs no forced devices
and no subprocess; where the JAX lattice spreads the rows over the devices
its 8 forced host devices leave (``data_shards = 8 // parties``), the port
takes that many row shards.  The masks are drawn from the JAX lattice's
keys (``PRNGKey(7)``, ``(3)``, ``(9)`` and ``(0)``, ``core/prng.py``), so
each check sees the JAX check's masks.

Contracts, as in the JAX package:

* **strict** (``check*``): raw transports, top-k, GOSS and the async
  exchange build trees bit-identical to the centralized builder, features
  and thresholds equal and leaves and predictions within rtol 1e-5 /
  atol 1e-6 — the data axis sums its shards' partials in shard order, not
  in row order, so its leaves may sit an ulp apart;
* **tolerance** (``check_tolerance`` and kin): lossy transports, sibling
  subtraction against the direct pass and shared root keep the end AUC
  and logloss within 5e-3 of the centralized model;
* **reconciliation**: every phase's measured bytes equal the wire model's
  exactly, chaos retries and per-shard routing bitmaps included;
* **chaos** and **degradation**: a ``-chaos`` twin trains the bit-identical
  model under faults, and a masked federated run equals the masked
  centralized one, with no split on a degraded column.

Exits non-zero on any mismatch; prints the lattice's wall time.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import binning, boosting, forest, losses, metrics, prng
from repro_torch.core import objective as objective_mod
from repro_torch.core.types import FedGBFConfig, TreeConfig, pack_ensemble
from repro_torch.device import resolve
from repro_torch.federation import (
    chaos as chaos_mod,
    compress,
    gradientless,
    mesh_roles,
    runtime,
    vfl,
)

#: the JAX lattice's forced host devices: a sharded check spreads the rows
#: over ``DEVICES // parties`` data shards
DEVICES = 8
LEAF_RTOL, LEAF_ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")


def _masks(seed: int, n: int, d: int, n_trees: int, rho_id: float,
           rho_feat: float, device):
    """``forest.sample_masks(PRNGKey(seed), ...)``, as the JAX check
    draws them."""
    return forest.sample_masks(prng.PRNGKey(seed, device), n, d, n_trees,
                               rho_id, rho_feat)


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device)


def _assert_lossless(trees_c, pred_c, trees_f, pred_f, what: str,
                     leaves: bool = True) -> None:
    assert torch.equal(trees_c.feature, trees_f.feature), \
        f"feature mismatch ({what})"
    assert torch.equal(trees_c.threshold, trees_f.threshold), \
        f"threshold mismatch ({what})"
    if leaves:
        torch.testing.assert_close(trees_f.leaf_weight, trees_c.leaf_weight,
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL)
    torch.testing.assert_close(pred_f, pred_c, rtol=LEAF_RTOL,
                               atol=LEAF_ATOL)


def check(num_parties: int, aggregation: str, shard_samples: bool,
          subtraction: bool = False, max_depth: int = 3,
          max_active_nodes: int = 0, data_shards: int = 0,
          async_exchange: bool = False, n: int = 512,
          loss: str = "logistic", device=CPU) -> None:
    """Fed-vs-central: features and thresholds equal, leaves and
    predictions within rtol 1e-5 / atol 1e-6.  ``data_shards`` pins the
    row-shard count of a sharded check (0 = ``DEVICES // parties``); an
    ``n`` not divisible by it exercises the weight-0 row padding."""
    shards = (data_shards or DEVICES // num_parties) if shard_samples else 1
    rng = np.random.default_rng(0)
    obj = objective_mod.get_objective(loss)
    d = num_parties * 3
    x = _tensor(rng.normal(size=(n, d)).astype(np.float32), device)
    y = _tensor(rng.integers(0, max(2, obj.n_classes), n).astype(np.float32),
                device)
    cfg = TreeConfig(max_depth=max_depth, num_bins=16,
                     hist_subtraction=subtraction,
                     max_active_nodes=max_active_nodes)
    binned, _ = binning.fit_bin(x, cfg.num_bins)
    g, h = obj.grad_hess(y, obj.init_raw(n, device=device))
    smask, fmask = _masks(7, n, d, 4, 0.8, 1.0, device)
    trees_c, pred_c = forest.build_forest(binned, g, h, smask, fmask, cfg)
    backend = vfl.make_vfl_backend(
        num_parties, cfg, aggregation=aggregation,
        shard_samples=shard_samples, data_shards=shards,
        async_exchange=async_exchange)
    trees_f, pred_f = backend.build_forest(binned, g, h, smask, fmask, cfg)
    _assert_lossless(trees_c, pred_c, trees_f, pred_f,
                     f"{aggregation}, shard_samples={shard_samples}")
    print(f"OK lossless: parties={num_parties} aggregation={aggregation} "
          f"shard_samples={shard_samples} subtraction={subtraction} "
          f"depth={max_depth} budget={max_active_nodes} "
          f"data_shards={shards} async={async_exchange} n={n} loss={loss}")


def check_no_valid_split(num_parties: int, aggregation: str,
                         degenerate: str, device=CPU) -> None:
    """No valid split anywhere (every gain <= 0, or min_child_weight
    filters every candidate): the federated trees equal the centralized
    split-free ones."""
    rng = np.random.default_rng(13)
    n, d = 256, num_parties * 2
    x = _tensor(rng.normal(size=(n, d)).astype(np.float32), device)
    y = _tensor(rng.integers(0, 2, n).astype(np.float32), device)
    if degenerate == "gamma":
        cfg = TreeConfig(max_depth=2, num_bins=8, gamma=1e9)
    else:
        cfg = TreeConfig(max_depth=2, num_bins=8, min_child_weight=1e9)
    binned, _ = binning.fit_bin(x, cfg.num_bins)
    g, h = losses.grad_hess("logistic", y, torch.zeros(n, device=device))
    smask, fmask = _masks(3, n, d, 3, 0.9, 1.0, device)
    trees_c, pred_c = forest.build_forest(binned, g, h, smask, fmask, cfg)
    assert bool((trees_c.feature == -1).all()), "expected a split-free tree"
    backend = vfl.make_vfl_backend(num_parties, cfg, aggregation=aggregation)
    trees_f, pred_f = backend.build_forest(binned, g, h, smask, fmask, cfg)
    _assert_lossless(trees_c, pred_c, trees_f, pred_f,
                     f"no valid split, {aggregation}, {degenerate}")
    print(f"OK no-valid-split lossless: parties={num_parties} "
          f"aggregation={aggregation} degenerate={degenerate}")


def check_topk_lossless(num_parties: int, k: int, device=CPU) -> None:
    """Top-k candidate pruning is lossless for any k >= 1."""
    rng = np.random.default_rng(5)
    n, d = 512, num_parties * 3
    x = _tensor(rng.normal(size=(n, d)).astype(np.float32), device)
    y = _tensor(rng.integers(0, 2, n).astype(np.float32), device)
    cfg = TreeConfig(max_depth=3, num_bins=16)
    binned, _ = binning.fit_bin(x, cfg.num_bins)
    g, h = losses.grad_hess("logistic", y, torch.zeros(n, device=device))
    smask, fmask = _masks(7, n, d, 4, 0.8, 1.0, device)
    trees_c, pred_c = forest.build_forest(binned, g, h, smask, fmask, cfg)
    backend = vfl.make_vfl_backend(
        num_parties, cfg, aggregation="argmax",
        transport=compress.TransportSpec(kind="topk", k=k))
    trees_f, pred_f = backend.build_forest(binned, g, h, smask, fmask, cfg)
    _assert_lossless(trees_c, pred_c, trees_f, pred_f, f"topk k={k}",
                     leaves=False)
    print(f"OK topk lossless: parties={num_parties} k={k}")


def check_goss_lossless(num_parties: int, aggregation: str,
                        device=CPU) -> None:
    """GOSS is a masking policy, not a transport: the same weight masks
    give the same trees federated and centralized."""
    rng = np.random.default_rng(11)
    n, d = 512, num_parties * 2
    x = _tensor(rng.normal(size=(n, d)).astype(np.float32), device)
    y = _tensor(rng.integers(0, 2, n).astype(np.float32), device)
    cfg = TreeConfig(max_depth=3, num_bins=16)
    binned, _ = binning.fit_bin(x, cfg.num_bins)
    g, h = losses.grad_hess("logistic", y, torch.zeros(n, device=device))
    n_top, n_rand = forest.goss_counts(n, 0.4, 0.5)
    smask, fmask = forest.goss_masks(prng.PRNGKey(9, device), g, d, 3,
                                     n_top, n_rand, d)
    trees_c, pred_c = forest.build_forest(binned, g, h, smask, fmask, cfg)
    backend = vfl.make_vfl_backend(num_parties, cfg, aggregation=aggregation)
    trees_f, pred_f = backend.build_forest(binned, g, h, smask, fmask, cfg)
    _assert_lossless(trees_c, pred_c, trees_f, pred_f,
                     f"goss, {aggregation}")
    print(f"OK goss lossless: parties={num_parties} aggregation="
          f"{aggregation}")


def _metric_deltas(y, model_a, model_b, x) -> dict:
    out = {}
    for name, fn in (
        ("auc", lambda m: float(metrics.auc(y, boosting.predict(m, x)))),
        ("logloss", lambda m: float(losses.loss_value(
            "logistic", y, boosting.predict(m, x)))),
    ):
        out[name] = abs(fn(model_a) - fn(model_b))
    return out


def _tolerance_data(num_parties: int, device):
    rng = np.random.default_rng(17)
    n, d = 2000, num_parties * 2
    x = rng.normal(size=(n, d)).astype(np.float32)
    logit = x[:, 0] - 0.8 * x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = (logit + rng.normal(0, 0.7, n) > 0).astype(np.float32)
    return _tensor(x, device), _tensor(y, device)


def _train(x, y, cfg, device, backend="local", **kw):
    model, _ = boosting.train_fedgbf(x, y, cfg, prng.PRNGKey(0),
                                     backend=backend, device=device, **kw)
    return model


def check_tolerance(num_parties: int, aggregation: str, transport,
                    bound: float = 5e-3, subtraction: bool = False,
                    device=CPU) -> None:
    """Lossy transports: |AUC_c - AUC_f| and |logloss_c - logloss_f| of a
    full run within ``bound`` (same config, same masks)."""
    x, y = _tolerance_data(num_parties, device)
    cfg = FedGBFConfig(
        rounds=4, n_trees_max=3, n_trees_min=2, rho_id_min=0.5,
        rho_id_max=0.8,
        tree=TreeConfig(max_depth=3, num_bins=32,
                        hist_subtraction=subtraction))
    model_c = _train(x, y, cfg, device)
    model_f = _train(x, y, cfg, device, vfl.make_vfl_backend(
        num_parties, cfg.tree, aggregation=aggregation, transport=transport))
    deltas = _metric_deltas(y, model_c, model_f, x)
    for name, delta in deltas.items():
        assert delta <= bound, (
            f"{name} delta {delta:.2e} exceeds tolerance {bound:.0e} "
            f"({aggregation}, transport={transport.tag}, "
            f"subtraction={subtraction})")
    print(f"OK tolerance: parties={num_parties} transport={transport.tag} "
          f"subtraction={subtraction} "
          + " ".join(f"d_{k}={v:.1e}" for k, v in deltas.items()))


def check_subtraction_vs_direct(bound: float = 5e-3, device=CPU) -> None:
    """Derived right siblings differ from direct ones only by float
    reassociation: end metrics within ``bound``."""
    x, y = _tolerance_data(2, device)
    base = FedGBFConfig(
        rounds=4, n_trees_max=3, n_trees_min=2, rho_id_min=0.5,
        rho_id_max=0.8,
        tree=TreeConfig(max_depth=3, num_bins=32, hist_subtraction=False))
    sub = dataclasses.replace(
        base, tree=dataclasses.replace(base.tree, hist_subtraction=True))
    deltas = _metric_deltas(y, _train(x, y, base, device), _train(x, y, sub,
                                                                  device), x)
    for name, delta in deltas.items():
        assert delta <= bound, (f"subtraction-vs-direct {name} delta "
                                f"{delta:.2e} exceeds {bound:.0e}")
    print("OK subtraction-vs-direct: "
          + " ".join(f"d_{k}={v:.1e}" for k, v in deltas.items()))


def check_reconciliation(num_parties: int, aggregation: str, transport,
                         shard_samples: bool = False,
                         subtraction: bool = False, max_depth: int = 3,
                         max_active_nodes: int = 0,
                         async_exchange: bool = False, n: int = 1536,
                         n_channels: int = 1, chaos=None, device=CPU) -> dict:
    """Measured payloads == the wire model, exactly, on every phase."""
    shards = DEVICES // num_parties if shard_samples else 0
    tree = TreeConfig(max_depth=max_depth, num_bins=32,
                      hist_subtraction=subtraction,
                      max_active_nodes=max_active_nodes)
    cfg = FedGBFConfig(rounds=3, n_trees_max=4, n_trees_min=2,
                       rho_id_min=0.2, rho_id_max=0.5)
    ledger = compress.reconciled_ledger(
        num_parties, tree, cfg, aggregation=aggregation,
        transport=transport, n_samples=n, num_features=num_parties * 2,
        async_exchange=async_exchange, n_channels=n_channels,
        device=device, chaos=chaos, data_shards=shards)
    rec = ledger.reconcile()
    tag = transport.tag if transport else "raw"
    assert ledger.matches(), (
        f"measured != predicted for {aggregation}/{tag}"
        f"{'+sub' if subtraction else ''}"
        f"{'+async' if async_exchange else ''}: {rec}")
    print(f"OK reconciliation: parties={num_parties} {aggregation}/{tag} "
          f"shard_samples={shard_samples} subtraction={subtraction} "
          f"depth={max_depth} budget={max_active_nodes} "
          f"async={async_exchange} n={n} K={n_channels} "
          f"total={rec['total']['measured']} bytes (exact match)")
    return rec


def check_gradientless(num_parties: int, loss: str = "logistic",
                       n: int = 600, device=CPU) -> dict:
    """Gradient-less mode: margins in and rates out, measured == the wire
    model exactly, every gradient-sharing phase zero, the rate fit no
    worse than the plain concatenation, every tree on its own party's
    columns."""
    obj = objective_mod.get_objective(loss)
    rng = np.random.default_rng(23)
    d = num_parties * 3
    x_np = rng.normal(size=(n, d)).astype(np.float32)
    logit = x_np[:, 0] - 0.8 * x_np[:, 1] + 0.5 * x_np[:, 2] * x_np[:, 3]
    if obj.n_classes > 1:
        cuts = np.quantile(logit, np.linspace(0, 1, obj.n_classes + 1)[1:-1])
        y_np = np.searchsorted(cuts, logit).astype(np.float32)
    else:
        y_np = (logit + rng.normal(0, 0.7, n) > 0).astype(np.float32)
    cfg = FedGBFConfig(rounds=3, n_trees_max=3, n_trees_min=2,
                       rho_id_min=0.5, rho_id_max=0.8, loss=loss,
                       tree=TreeConfig(max_depth=3, num_bins=16))
    meter = compress.MessageMeter()
    packed, info = gradientless.train_gradientless(
        x_np, y_np, cfg, prng.PRNGKey(0), num_parties, meter=meter,
        device=device)
    assert info["loss_after"] <= info["loss_before"] + 1e-6, info
    layout = mesh_roles.PartyLayout(num_parties, d)
    offset = 0
    for p, t_p in enumerate(info["tree_counts"]):
        feats = packed.feature[offset:offset + t_p]
        owned, _ = layout.local(feats[feats >= 0], p)
        assert bool(owned.all()), (
            f"party {p} tree references foreign columns")
        offset += t_p
    predicted = gradientless.wire_cost(n, info["tree_counts"],
                                       n_channels=obj.n_classes)
    measured = meter.phase_totals()
    for phase in ("histograms", "grad_broadcast", "id_partition"):
        assert measured.get(phase, 0) == 0 == predicted[phase], (
            f"gradient-less mode must ship zero {phase} bytes")
    for phase in ("tree_margins", "tree_scales"):
        assert measured[phase] == predicted[phase], (
            f"{phase}: measured {measured[phase]} != predicted "
            f"{predicted[phase]}")
    print(f"OK gradientless: parties={num_parties} loss={loss} "
          f"loss {info['loss_before']:.3f} -> {info['loss_after']:.3f}, "
          f"wire={sum(measured.values())} bytes "
          "(margins+rates only, exact match)")
    return info


def check_round_collective_counts(num_parties: int, n_trees: int,
                                  transport=None,
                                  async_exchange: bool = False,
                                  device=CPU) -> None:
    """One histogram exchange per level whatever T (two under
    quantization: int payload and scales), async included."""
    tree = TreeConfig(max_depth=3, num_bins=16)
    rc = compress.probe_round_collectives(
        num_parties, tree, n_trees, aggregation="histogram",
        transport=transport, n_samples=512, num_features=num_parties * 2,
        async_exchange=async_exchange, device=device)
    counts = rc["counts"]
    per_level = 2 if transport is not None else 1
    assert counts.get("histograms") == per_level * tree.max_depth, counts
    assert counts.get("feature_mask") == tree.max_depth, counts
    assert counts.get("id_partition") == tree.max_depth, counts
    tag = transport.tag if transport else "raw"
    print(f"OK round collectives: parties={num_parties} T={n_trees} "
          f"transport={tag} async={async_exchange} histogram records per "
          f"level == {per_level} ({tree.max_depth} levels)")


def check_id_partition_packing(num_parties: int, device=CPU) -> None:
    """The routing bitmap measures ceil(n/8) bytes a level, >= 8x under a
    byte a row and 32x under int32."""
    tree = TreeConfig(max_depth=3, num_bins=16)
    n = 1536
    per_tree, _ = compress.probe_tree_cost(
        num_parties, tree, aggregation="histogram", n_samples=n,
        num_features=num_parties * 2, device=device)
    packed = per_tree["id_partition"]
    assert packed == tree.max_depth * ((n + 7) // 8), per_tree
    unpacked_int32 = tree.max_depth * n * 4
    cut = unpacked_int32 / packed
    assert cut >= 8.0, f"id_partition cut {cut:.1f}x below the 8x bar"
    print(f"OK id_partition packing: {unpacked_int32} -> {packed} B/tree "
          f"({cut:.0f}x cut)")


def check_shared_root_tolerance(num_parties: int,
                                bound: float = 5e-3, device=CPU) -> None:
    """Shared root (high-rho schedule) tracks the direct pipeline within
    ``bound``, centralized and federated."""
    x, y = _tolerance_data(num_parties, device)
    base = FedGBFConfig(
        rounds=4, n_trees_max=3, n_trees_min=2, rho_id_min=0.6,
        rho_id_max=0.9, tree=TreeConfig(max_depth=3, num_bins=32))
    shared = dataclasses.replace(
        base, tree=dataclasses.replace(base.tree, shared_root=True))
    model_d = _train(x, y, base, device)
    model_s = _train(x, y, shared, device)
    model_f = _train(x, y, shared, device, vfl.make_vfl_backend(
        num_parties, shared.tree, aggregation="histogram"))
    for name, pair in (("central", model_s), ("federated", model_f)):
        for metric, delta in _metric_deltas(y, model_d, pair, x).items():
            assert delta <= bound, (f"shared-root {name} {metric} delta "
                                    f"{delta:.2e} exceeds {bound:.0e}")
    print("OK shared-root tolerance: central + federated within "
          f"{bound:.0e} of the direct pipeline")


def check_subtraction_hist_cut(num_parties: int, transport,
                               device=CPU) -> None:
    """Depth 3: 7 -> 4 node-histograms a tree, >= 1.7x, measured."""
    n = 1536
    measured = {}
    for sub in (False, True):
        tree = TreeConfig(max_depth=3, num_bins=32, hist_subtraction=sub)
        per_tree, _ = compress.probe_tree_cost(
            num_parties, tree, aggregation="histogram", transport=transport,
            n_samples=n, num_features=num_parties * 2, device=device)
        measured[sub] = per_tree["histograms"]
    cut = measured[False] / measured[True]
    tag = transport.tag if transport else "raw"
    assert cut >= 1.7, f"histogram-phase cut {cut:.3f}x below 1.7x ({tag})"
    print(f"OK subtraction hist cut: {tag} {measured[False]} -> "
          f"{measured[True]} B/tree ({cut:.2f}x)")


def _train_named(tcfg, cfg, x, y, backend_name, num_parties, device,
                 **kw):
    model = _train(x, y, cfg, device, backend_mod.get_backend(
        backend_name, tree=tcfg, num_parties=num_parties, **kw))
    return pack_ensemble(model)


def _same_packed(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("feature", "threshold", "gain", "leaf_weight",
                         "tree_scale", "bin_edges"))


def check_chaos(backend_name: str, num_parties: int = 4,
                n: int = 512, device=CPU) -> None:
    """The ``-chaos`` twin trains the bit-identical model, zero-fault and
    under injected faults (every fault detected and retransmitted)."""
    tcfg = TreeConfig(max_depth=3, num_bins=16)
    cfg = FedGBFConfig(rounds=2, n_trees_max=3, n_trees_min=2,
                       rho_id_min=0.5, rho_id_max=0.8, tree=tcfg)
    rng = np.random.default_rng(0)
    d = num_parties * 2
    x_np = rng.normal(size=(n, d)).astype(np.float32)
    x = _tensor(x_np, device)
    y = _tensor((rng.normal(size=n) + x_np[:, 0] > 0).astype(np.float32),
                device)
    shard_kw = ({"data_shards": DEVICES // num_parties}
                if "-sharded" in backend_name else {})
    base = _train_named(tcfg, cfg, x, y, backend_name, num_parties,
                        **shard_kw, device=device)
    zero_fault = _train_named(tcfg, cfg, x, y, backend_name + "-chaos",
                              num_parties, **shard_kw, device=device)
    assert _same_packed(base, zero_fault), (
        f"{backend_name}-chaos (zero-fault) diverged from {backend_name}")
    spec = chaos_mod.ChaosSpec(drop=0.10, corrupt=0.05, dup=0.05, seed=7)
    faulty = _train_named(tcfg, cfg, x, y, backend_name + "-chaos",
                          num_parties, chaos=spec, **shard_kw, device=device)
    assert _same_packed(base, faulty), (
        f"{backend_name}-chaos under {spec.tag} diverged: a fault escaped "
        "checksum detection")
    print(f"OK chaos bit-identity: {backend_name} (zero-fault AND "
          f"{spec.tag})")


def check_chaos_reconciliation(aggregation: str, transport,
                               num_parties: int = 4, n: int = 777,
                               device=CPU) -> None:
    """Under injected faults the ledger still reconciles exactly, the
    retransmissions in the ``retries`` phase."""
    tcfg = TreeConfig(max_depth=3, num_bins=16)
    cfg = FedGBFConfig(rounds=3, n_trees_max=4, n_trees_min=2,
                       rho_id_min=0.2, rho_id_max=0.5)
    spec = chaos_mod.ChaosSpec(drop=0.10, corrupt=0.05, dup=0.05, seed=7)
    ledger = compress.reconciled_ledger(
        num_parties, tcfg, cfg, aggregation=aggregation, transport=transport,
        n_samples=n, num_features=num_parties * 2, device=device, chaos=spec)
    rec = ledger.reconcile()
    tag = transport.tag if transport else "raw"
    assert ledger.matches(), f"chaos {aggregation}/{tag}: {rec}"
    assert rec["retries"]["measured"] > 0, (
        f"chaos {aggregation}/{tag}: no retry bytes measured under faults")
    print(f"OK chaos reconciliation: {aggregation}/{tag} "
          f"retries={rec['retries']['measured']}B "
          f"total={rec['total']['measured']}B (exact match)")


def check_degradation(num_parties: int = 4, n: int = 512, device=CPU) -> None:
    """Party dropout: the federated run with the degraded parties' columns
    masked (``round_feature_mask``) equals the masked centralized run bit
    for bit, and no tree splits on a degraded column in a masked round."""
    tcfg = TreeConfig(max_depth=3, num_bins=16)
    cfg = FedGBFConfig(rounds=4, n_trees_max=3, n_trees_min=2,
                       rho_id_min=0.5, rho_id_max=0.8, tree=tcfg)
    rng = np.random.default_rng(3)
    d = num_parties * 2
    x_np = rng.normal(size=(n, d)).astype(np.float32)
    x = _tensor(x_np, device)
    y = _tensor((rng.normal(size=n) + x_np[:, 0] > 0).astype(np.float32),
                device)
    sched = runtime.dropout_schedule(0.6, cfg.rounds, num_parties, seed=11,
                                     policy=runtime.RetryPolicy(
                                         max_retries=0))
    mask = runtime.degradation_masks(sched.degraded, d, num_parties)
    assert mask is not None and not mask.all(), (
        "oracle needs at least one degraded (round, party); reseed")
    model_f = pack_ensemble(_train(x, y, cfg, device, vfl.make_vfl_backend(
        num_parties, tcfg, aggregation="histogram"),
        round_feature_mask=mask))
    packed = pack_ensemble(_train(x, y, cfg, device, round_feature_mask=mask))
    assert _same_packed(model_f, packed), (
        "degraded fed run diverged from the masked-candidate oracle")
    assert_no_banned_splits(packed, mask)
    print(f"OK degradation oracle: {int(sched.degraded.sum())} degraded "
          "(round, party) cells, fed == masked-candidate central "
          "(bit-identical), no banned splits")


def assert_no_banned_splits(packed, mask: np.ndarray) -> None:
    """No split (gain > 0) of round r on a column ``mask[r]`` bans."""
    for r in range(packed.rounds):
        trees_r = packed.round_trees(r)
        feats = trees_r.feature.cpu().numpy()
        gains = trees_r.gain.cpu().numpy()
        hit = np.isin(feats, np.nonzero(~mask[r])[0]) & (gains > 0)
        assert not hit.any(), (f"round {r + 1} split on degraded "
                               f"column(s) {np.unique(feats[hit])}")


def chaos_checks(device=CPU) -> None:
    """The fault-tolerance slice: chaos twins across the lattice, exact
    reconciliation under faults, the degradation oracle."""
    for name in ("vfl-histogram", "vfl-histogram-q8", "vfl-histogram-q16",
                 "vfl-argmax", "vfl-argmax-topk", "vfl-histogram-async",
                 "vfl-histogram-async-q8", "vfl-histogram-sharded"):
        check_chaos(name, device=device)
    for aggregation, transport in (
        ("histogram", None), ("histogram", compress.Q8),
        ("argmax", None), ("argmax", compress.TOPK),
    ):
        check_chaos_reconciliation(aggregation, transport, device=device)
    check_degradation(device=device)


def lattice(device=CPU) -> None:
    """The JAX selftest's ``main`` lattice, then its chaos slice."""
    for aggregation in ("histogram", "argmax"):
        for shard_samples in (False, True):
            check(4, aggregation, shard_samples, device=device)
    check(2, "histogram", True, device=device)
    for aggregation in ("histogram", "argmax"):
        check(2, aggregation, True, data_shards=2, device=device)
    check(2, "histogram", True, data_shards=2, n=509, device=device)
    check(4, "histogram", True, data_shards=2, subtraction=True, n=507,
          device=device)
    check(4, "histogram", False, async_exchange=True, device=device)
    check(4, "histogram", True, async_exchange=True, subtraction=True,
          device=device)
    check(2, "histogram", True, data_shards=2, async_exchange=True, n=509,
          device=device)
    check(4, "histogram", False, async_exchange=True, subtraction=True,
          max_depth=4, max_active_nodes=4, device=device)
    for aggregation in ("histogram", "argmax"):
        check(4, aggregation, False, loss="softmax3", device=device)
    check(4, "histogram", True, subtraction=True, loss="softmax3",
          device=device)
    check(4, "histogram", False, async_exchange=True, subtraction=True,
          loss="softmax3", device=device)
    check(2, "histogram", True, data_shards=2, loss="softmax3", n=509,
          device=device)
    check(4, "histogram", False, subtraction=True, max_depth=4,
          max_active_nodes=4, loss="softmax3", device=device)
    check(4, "histogram", False, loss="quantile@0.9", device=device)
    check_gradientless(4, loss="logistic", device=device)
    check_gradientless(2, loss="softmax3", device=device)
    for aggregation in ("histogram", "argmax"):
        check(4, aggregation, False, subtraction=True, device=device)
    check(4, "histogram", True, subtraction=True, device=device)
    check_subtraction_vs_direct(device=device)
    for max_depth, budget in ((4, 4), (5, 4), (5, 8)):
        check(4, "histogram", False, subtraction=True, max_depth=max_depth,
              max_active_nodes=budget, device=device)
    check(4, "argmax", False, max_depth=5, max_active_nodes=4, device=device)
    check(4, "histogram", True, subtraction=True, max_depth=4,
          max_active_nodes=4, device=device)
    for n_trees in (1, 4):
        check_round_collective_counts(4, n_trees, device=device)
    for transport in (None, compress.Q8):
        check_round_collective_counts(4, 4, transport=transport,
                                      async_exchange=True, device=device)
    check_id_partition_packing(4, device=device)
    check_shared_root_tolerance(2, device=device)
    for aggregation in ("histogram", "argmax"):
        for degenerate in ("gamma", "min_child_weight"):
            check_no_valid_split(4, aggregation, degenerate, device=device)
    for k in (1, 4):
        check_topk_lossless(4, k, device=device)
    for aggregation in ("histogram", "argmax"):
        check_goss_lossless(4, aggregation, device=device)
    for transport in (compress.Q8, compress.Q16):
        check_tolerance(2, "histogram", transport, device=device)
    check_tolerance(2, "histogram", compress.Q8, subtraction=True,
                    device=device)
    for aggregation, transport in (
        ("histogram", None), ("histogram", compress.Q8),
        ("histogram", compress.Q16), ("argmax", None),
        ("argmax", compress.TOPK),
    ):
        check_reconciliation(4, aggregation, transport, device=device)
    for aggregation, transport in (
        ("histogram", None), ("histogram", compress.Q8), ("argmax", None),
    ):
        check_reconciliation(4, aggregation, transport, subtraction=True,
                             device=device)
    for transport in (None, compress.Q8):
        check_subtraction_hist_cut(4, transport, device=device)
    for transport, subtraction in ((None, True), (None, False),
                                   (compress.Q8, True)):
        check_reconciliation(4, "histogram", transport,
                             subtraction=subtraction, max_depth=5,
                             max_active_nodes=4, device=device)
    check_reconciliation(4, "histogram", compress.Q8, shard_samples=True,
                         device=device)
    check_reconciliation(2, "argmax", None, shard_samples=True, device=device)
    check_reconciliation(4, "histogram", None, shard_samples=True, n=1531,
                         device=device)
    check_reconciliation(2, "argmax", None, shard_samples=True, n=999,
                         device=device)
    check_reconciliation(4, "histogram", None, async_exchange=True,
                         device=device)
    check_reconciliation(4, "histogram", compress.Q16, async_exchange=True,
                         device=device)
    check_reconciliation(4, "histogram", compress.Q8, shard_samples=True,
                         subtraction=True, async_exchange=True, n=1531,
                         device=device)
    check_reconciliation(4, "histogram", None, n_channels=3, device=device)
    check_reconciliation(4, "histogram", compress.Q8, subtraction=True,
                         n_channels=3, device=device)
    check_reconciliation(4, "histogram", compress.Q8, shard_samples=True,
                         subtraction=True, async_exchange=True, n=1531,
                         n_channels=3, device=device)
    chaos_checks(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every check (no CPU fallback)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    t0 = time.perf_counter()
    lattice(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"ALL FEDERATION SELF-TESTS PASSED on {device} in "
          f"{time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
