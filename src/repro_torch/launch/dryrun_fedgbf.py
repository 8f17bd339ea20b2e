"""The paper's own workload on the production grid: one FedGBF forest round
(5 depth-3 trees, Give-Me-Some-Credit scale) built by the federated
runtime with 16 parties on the model axis and the samples over the data
axis: the counterpart of ``repro/launch/dryrun_fedgbf.py``.

The JAX script only compiles the round on 256 (or 512) forced devices and
reads its collective bytes from the HLO.  The port runs it on one card:
the parties are column blocks and the data shards row blocks
(``federation/mesh_roles.py``), so a (16 data x 16 party) grid is 256
(party, shard) blocks, and each level one histogram-kernel launch over all
of them (the shard folded into the node id).  Each run reports the wire
bytes the run metered per phase, their delta against the wire model
(``compress.reconciled_ledger``; must be 0), the histogram launches (one a
level on the card), the wall, and three roofline terms on one card's rates
(``launch/mesh.py``).  The exchange bytes are the wire bytes but the (g,
h) broadcast, which the JAX program receives as a replicated input and so
holds no collective for: what the JAX script's compiled collective bytes
count.

* ``compute_s``: the histogram adds (3 a weighted row, feature and level)
  over the float32 peak;
* ``memory_s``: the bytes the histogram launches must move (each input
  read once a level, each histogram written once) over the HBM rate;
* ``collective_s``: the exchange bytes over the link rate.

The sweep (``main``) prints the JAX script's three ratios of exchange
bytes: async over sync (exactly 1.000), the subtraction cut and the
depth-5 frontier compaction cut; and checks that ``histogram``, its async
twin and ``argmax`` build ``local-cuda``'s trees on the same columns and
masks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_fedgbf [--trace]
    PYTHONPATH=src python -m repro_torch.launch.dryrun_fedgbf --device cpu \
        --n 4096
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import binning, forest, losses, prng
from repro_torch.core.types import FedGBFConfig, TreeConfig
from repro_torch.data import synthetic, tabular
from repro_torch.device import resolve
from repro_torch.federation import compress, protocol, vfl
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.launch.dryrun import REPORT_DIR
from repro_torch.launch.mesh import (
    HBM_BW,
    ICI_BW,
    PEAK_FLOPS_FP32,
    make_production_mesh,
    make_vfl_mesh,
)
from repro_torch.obs import perfetto
from repro_torch.obs.trace import NULL_TRACER, Tracer

PARTIES = 16
NUM_BINS = 32
RHO_ID = 0.1            # Dynamic FedGBF's first round: 5 trees at 0.1
#: ``-sharded`` leaves against the unsharded build: the shard partials sum
#: in shard order (ROADMAP §1 A); features and thresholds are exact
LEAF_RTOL, LEAF_ATOL = 1e-5, 1e-6


def round_inputs(n: int, n_pad: int, d: int, n_trees: int,
                 device) -> dict:
    """The round's inputs: Give-Me-Some-Credit's ``n`` rows (train and test
    together) padded to ``d`` columns, binned to 32; logistic g and h at a
    zero margin; masks drawn from ``PRNGKey(0)`` (5 trees at rho_id 0.1,
    every feature); the rows padded to ``n_pad`` with weight 0."""
    ds = synthetic.load("give_me_some_credit", n=n)
    x = np.concatenate([ds.x_train, ds.x_test])
    y = np.concatenate([ds.y_train, ds.y_test])
    x, d_pad = tabular.pad_features(x, d)
    if d_pad != d:
        raise ValueError(f"{ds.name} pads to {d_pad} columns, not {d}")
    binned, _ = binning.fit_bin(torch.from_numpy(x), NUM_BINS)
    g, h = losses.logistic_grad_hess(torch.from_numpy(y).float(),
                                     torch.zeros(n))
    smask, fmask = forest.sample_masks_counts(
        prng.PRNGKey(0), n, d, n_trees, forest.sample_keep_count(n, RHO_ID),
        d)
    pad = n_pad - n
    rows = torch.nn.functional.pad
    return {"binned": rows(binned, (0, 0, 0, pad)).to(device),
            "g": rows(g, (0, pad)).to(device),
            "h": rows(h, (0, pad)).to(device),
            "smask": rows(smask, (0, pad)).to(device),
            "fmask": fmask.to(device)}


def histogram_work(inputs: dict, shards: int,
                   tree: TreeConfig) -> tuple[float, float]:
    """(bytes, adds) of the round's histogram launches: one a level over
    the whole (n, d) table, its bins, assignments, g, h and weights read
    once and the histogram (T trees x shards x nodes x columns x bins x 3:
    every (party, shard) block's) written once; 3 adds a weighted row and
    column (the direct form's count, an upper bound at a child level)."""
    n, d = inputs["binned"].shape
    T = inputs["smask"].shape[0]
    weighted = float((inputs["smask"] != 0).sum())
    nbytes = adds = 0.0
    for level in range(tree.max_depth):
        nodes = protocol._nodes_sent(level, tree.hist_subtraction,
                                     tree.max_active_nodes)
        nbytes += (n * d * 4 + 2 * T * n * 4 + 2 * n * 4
                   + T * shards * nodes * d * NUM_BINS * 3 * 4)
        adds += 3 * weighted * d
    return nbytes, adds


def _grid(multi_pod: bool, data_shards: int) -> tuple[str, int, int]:
    """(name, parties, data shards): the production grid with pod folded
    into data, or ``data_shards`` x 16."""
    if data_shards:
        mesh = make_vfl_mesh(PARTIES, data_shards)
        return f"{data_shards}x{PARTIES}", PARTIES, mesh.shape["data"]
    mesh = make_production_mesh(multi_pod=multi_pod)
    shards = mesh.size // mesh.shape["model"]
    return ("2x16x16" if multi_pod else "16x16"), mesh.shape["model"], shards


def _same_trees(a, b) -> tuple[bool, float]:
    """(features and thresholds equal, leaves within the -sharded
    tolerance; the max leaf |diff|)."""
    exact = (torch.equal(a.feature, b.feature)
             and torch.equal(a.threshold, b.threshold))
    diff = float((a.leaf_weight - b.leaf_weight).abs().max())
    close = torch.allclose(a.leaf_weight, b.leaf_weight, rtol=LEAF_RTOL,
                           atol=LEAF_ATOL)
    return exact and close, diff


def run(aggregation: str, n: int = 150_000, d: int = 16, n_trees: int = 5,
        multi_pod: bool = False, hist_subtraction: bool = False,
        max_depth: int = 3, max_active_nodes: int = 0, data_shards: int = 0,
        async_exchange: bool = False, device="cuda", tracer=NULL_TRACER,
        oracle: bool = False, cache: dict | None = None,
        save: bool = True) -> dict:
    """Build one forest round on the grid and check it: the meter equals
    the wire model on every phase (delta 0), and on the card the histogram
    kernel launched once a level.  ``oracle`` also holds the trees against
    ``local-cuda``'s on the same inputs, and reports the oracle build's
    launches apart.  ``cache`` keeps inputs (and oracle trees) between runs
    of one sweep."""
    device = resolve(device)
    cache = {} if cache is None else cache
    grid, parties, shards = _grid(multi_pod, data_shards)
    # round n up to the shard granularity: padded rows carry weight 0
    n_pad = -(-n // shards) * shards
    key = (n, n_pad, d, n_trees)
    if key not in cache:
        cache[key] = round_inputs(n, n_pad, d, n_trees, device)
    inputs = cache[key]
    tree = TreeConfig(max_depth=max_depth, num_bins=NUM_BINS,
                      hist_subtraction=hist_subtraction,
                      max_active_nodes=max_active_nodes)
    meter = compress.MessageMeter()
    backend = vfl.make_vfl_backend(
        parties, tree, aggregation=aggregation, meter=meter,
        async_exchange=async_exchange, shard_samples=True,
        data_shards=shards)
    args = (inputs["binned"], inputs["g"], inputs["h"], inputs["smask"],
            inputs["fmask"], tree)
    tag = (f"fedgbf__forest_round__{grid}__{aggregation}"
           + ("__sub" if hist_subtraction else "")
           + ("__async" if async_exchange else "")
           + (f"__d{max_depth}" if max_depth != 3 else "")
           + (f"__a{max_active_nodes}" if max_active_nodes else ""))

    hist_ops.reset_launches()
    _sync(device)
    with tracer.span(f"round[{tag}]", cat="dryrun",
                     args={"parties": parties, "shards": shards, "n": n_pad,
                           "d": d}):
        t0 = time.perf_counter()
        trees, _ = backend.build_forest(*args)
        _sync(device)
        wall = time.perf_counter() - t0
    launches = hist_ops.kernel_launches("histogram_round")
    sorts = hist_ops.kernel_launches("histogram_sort")
    if device.type == "cuda":
        _check(launches == max_depth == sorts,
               f"{tag}: {launches} histogram launches ({sorts} sorts) == "
               f"{max_depth} levels, one for all {parties} parties x "
               f"{shards} shards")

    cfg = FedGBFConfig(rounds=1, n_trees_max=n_trees, n_trees_min=n_trees,
                       tree=tree)
    ledger = compress.reconciled_ledger(
        parties, tree, cfg, aggregation=aggregation, n_samples=n_pad,
        num_features=d, async_exchange=async_exchange, data_shards=shards,
        device=device)
    rec = ledger.reconcile()
    _check(all(v["delta"] == 0 for v in rec.values()),
           f"{tag}: wire bytes reconcile on every phase: {rec}")
    passive = parties - 1
    measured = {}
    for phase, nbytes in meter.phase_totals().items():
        mult = passive if phase in protocol.PER_PASSIVE_PHASES else 1
        measured[phase] = mult * nbytes
        _check(measured[phase] == ledger.measured[phase],
               f"{tag}: the run's meter, {phase}: {measured[phase]} == the "
               f"ledger's {ledger.measured[phase]}")
    wire = sum(measured.values())
    exchange = wire - measured.get("grad_broadcast", 0)

    leaf_diff = None
    oracle_launches = oracle_sorts = 0
    if oracle:
        okey = (key, tree)
        if okey not in cache:
            hist_ops.reset_launches()
            local = backend_mod.get_backend("local-cuda")
            cache[okey] = local.build_forest(*args)[0]
            oracle_launches = hist_ops.kernel_launches("histogram_round")
            oracle_sorts = hist_ops.kernel_launches("histogram_sort")
        same, leaf_diff = _same_trees(trees, cache[okey])
        _check(same, f"{tag}: trees == local-cuda's (features, thresholds "
               f"exact; leaves within rtol {LEAF_RTOL} atol {LEAF_ATOL}, "
               f"max |diff| {leaf_diff:.3e})")

    nbytes, adds = histogram_work(inputs, shards, tree)
    report = {
        "tag": tag, "status": "ok", "aggregation": aggregation,
        "hist_subtraction": hist_subtraction,
        "async_exchange": async_exchange, "data_shards": shards,
        "parties": parties, "max_depth": max_depth,
        "max_active_nodes": max_active_nodes, "n": n_pad, "d": d,
        "n_trees": n_trees, "device": str(device),
        "wall_s": wall, "histogram_launches": launches,
        "sort_launches": sorts,
        "oracle_histogram_launches": oracle_launches,
        "oracle_sort_launches": oracle_sorts,
        "wire_bytes": wire, "exchange_bytes": exchange,
        "wire_bytes_by_phase": measured,
        "wire_delta": {k: v["delta"] for k, v in rec.items()},
        "leaf_max_abs_diff_vs_local": leaf_diff,
        "hist_bytes": nbytes, "hist_adds": adds,
        "compute_s": adds / PEAK_FLOPS_FP32,
        "memory_s": nbytes / HBM_BW,
        "collective_s": exchange / ICI_BW,
    }
    tracer.counter("dryrun_exchange_bytes", {tag: exchange})
    if save:
        os.makedirs(REPORT_DIR, exist_ok=True)
        with open(os.path.join(REPORT_DIR, tag + ".json"), "w") as f:
            json.dump(report, f, indent=1)
    print(f"[OK] {tag}: wall {wall * 1e3:.1f} ms, {launches} histogram "
          f"launches, wire {wire:,} B (delta 0) "
          + ", ".join(f"{k} {v:,}" for k, v in measured.items() if v)
          + f"; compute {report['compute_s'] * 1e3:.6f} ms, memory "
          f"{report['memory_s'] * 1e3:.6f} ms, collective "
          f"{report['collective_s'] * 1e3:.6f} ms"
          + (f"; trees == local-cuda (leaves {leaf_diff:.2e})"
             if oracle else ""))
    return report


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def sweep(device="cuda", n: int = 150_000, data_shards: int = 0,
          tracer=NULL_TRACER, save: bool = True) -> dict:
    """The JAX script's sweep: ``histogram`` and ``argmax`` on the
    single-pod and multi-pod grids (those four and the async run held
    against ``local-cuda``), ``histogram`` with the async exchange, with
    subtraction, and at depth 5 with subtraction with and without
    ``max_active_nodes=4``; with ``data_shards`` also ``histogram`` and its
    async twin on a (data_shards x 16) grid.  Returns ``{"runs": [...],
    "ratios": {...}}``; any failed check raises."""
    cache: dict = {}
    kw = dict(n=n, device=device, tracer=tracer, cache=cache, save=save)
    runs = []
    base = None
    for multi_pod in (False, True):
        for agg in ("histogram", "argmax"):
            runs.append(run(agg, multi_pod=multi_pod, oracle=True, **kw))
            if agg == "histogram" and not multi_pod:
                base = runs[-1]
    # the double-buffered exchange: the same logical payload in two
    # transfers, metered once; the wire bytes must not grow
    async_r = run("histogram", async_exchange=True, oracle=True, **kw)
    runs.append(async_r)
    ratios = {"async_over_sync": (async_r["exchange_bytes"]
                                  / base["exchange_bytes"])}
    _check(async_r["wire_bytes_by_phase"] == base["wire_bytes_by_phase"],
           "async wire bytes == sync's on every phase")
    print(f"[OK] async exchange bytes ratio vs sync: "
          f"{ratios['async_over_sync']:.3f}x (must be exactly 1)")
    if data_shards:
        runs.append(run("histogram", data_shards=data_shards, **kw))
        runs.append(run("histogram", data_shards=data_shards,
                        async_exchange=True, **kw))
    # sibling subtraction on the full-histogram exchange: only the left
    # children ship at levels >= 1
    sub = run("histogram", hist_subtraction=True, **kw)
    runs.append(sub)
    ratios["subtraction_cut"] = base["exchange_bytes"] / sub["exchange_bytes"]
    print(f"[OK] subtraction exchange-bytes cut (histogram mode): "
          f"{ratios['subtraction_cut']:.2f}x")
    # frontier compaction at depth 5: the live-slot budget ships, not the
    # 2^L frontier
    deep = run("histogram", hist_subtraction=True, max_depth=5, **kw)
    comp = run("histogram", hist_subtraction=True, max_depth=5,
               max_active_nodes=4, **kw)
    runs += [deep, comp]
    ratios["compaction_cut"] = (deep["exchange_bytes"]
                                / comp["exchange_bytes"])
    print(f"[OK] depth-5 frontier-compaction exchange-bytes cut: "
          f"{ratios['compaction_cut']:.2f}x")
    return {"runs": runs, "ratios": ratios}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-shards", type=int, default=0,
                    help="also run an explicit (data_shards x 16) grid")
    ap.add_argument("--n", type=int, default=150_000,
                    help="rows (the JAX script's 150,000)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (no silent CPU fallback)")
    ap.add_argument("--trace", nargs="?", const=os.path.join(
                        REPORT_DIR, "dryrun_fedgbf_trace.json"),
                    default=None, metavar="OUT.json",
                    help="export the sweep's per-run spans as a Perfetto-"
                         "loadable Chrome trace")
    args = ap.parse_args(argv)
    tracer = Tracer() if args.trace else NULL_TRACER
    sweep(args.device, n=args.n, data_shards=args.data_shards,
          tracer=tracer)
    if args.trace:
        n_events = perfetto.export_chrome_trace(
            args.trace, tracer, metadata={"entry": "dryrun_fedgbf"})
        print(f"[OK] dryrun trace: {n_events} events -> {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
