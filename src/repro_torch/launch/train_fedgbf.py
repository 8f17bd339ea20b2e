"""FedGBF training driver: the counterpart of
``repro/launch/train_fedgbf.py``.

    # on the card (the defaults: --backend local-cuda --device cuda)
    PYTHONPATH=src python -m repro_torch.launch.train_fedgbf --rounds 20

    # on the CPU, through the kernel's plain version or the plain providers
    PYTHONPATH=src python -m repro_torch.launch.train_fedgbf --device cpu \
        --rounds 3 --n 2000 [--backend local] [--sampling goss]

    # vertically federated: 4 parties as column blocks on one card, every
    # party's histogram on the kernel; prints the wire-byte ledger
    PYTHONPATH=src python -m repro_torch.launch.train_fedgbf --rounds 20 \
        --backend vfl-histogram --parties 4 [--device cpu]

    # kill and resume: checkpoint the train state every N rounds (atomic
    # npz + sha256 sidecar, the JAX package's layout), stop after round K,
    # resume to the bytes of an uninterrupted run
    ... --checkpoint ckpt/run --checkpoint-every 2 --stop-after-round 3
    ... --checkpoint ckpt/run --checkpoint-every 2 --resume

Masks: every scheduled tree build's masks (under ``--sampling goss``: its
uniforms and feature masks) are drawn from ``PRNGKey(0)`` as the JAX
launcher draws them (``core/prng.py``), for the whole schedule, so a
resumed run replays them and the run trains the JAX launcher's trees.
``--masks PATH.npz`` overrides the draw with explicit masks:
``sample_bits`` as ``np.packbits`` rows, ``feature`` and ``n`` (the format
of ``testdata/dynamic_fedgbf_r20_train.npz``), or under GOSS ``uniform``
and ``feature``.
``--checkpoint PATH`` is the train-state path, as in the JAX launcher; the
packed model for serving comes from ``serve_fedgbf --save``.  A state
written on the card resumes on the CPU and the reverse: the fingerprint
leaves out ``--device`` and ``--backend``.

Federated backends (``vfl-histogram[-async][-q8|-q16]``,
``vfl-argmax[-topk]``, each with its ``-sharded`` / ``-chaos`` twins): the
features are padded with constant columns (``tabular.pad_features``) until
``--parties`` divides them, the masks are drawn for the padded width, and
the run prints the JAX launcher's lines: the backend and its transport,
the Paillier-model estimate and the measured wire bytes against the wire
model's (``match=``), from the port's dry probe
(``compress.reconciled_ledger``).  The port has one training engine, with
the JAX scan engine's contract: ``--engine scan``; ``loop`` is refused.

    # the data axis: 2 row shards on the one card (a -sharded name)
    ... --backend vfl-histogram-sharded --parties 4 --data-shards 2
    # chaos transport: rates > 0 select the -chaos twin (bit-identical
    # trees; the retransmissions show in the ledger's retries phase)
    ... --backend vfl-histogram --chaos-drop 0.05 --chaos-corrupt 0.02
    # party dropout: degraded (round, party) cells leave the split search;
    # the degraded parties also fit gradient-less local trees
    ... --backend vfl-histogram --party-dropout 0.5 --retry-max 0 \
        --dropout-fallback gradientless

``--data-shards 0`` is one shard; the shards are row blocks of the one
card, so a count above 1 needs a ``-sharded`` backend and is refused on
any other.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json

import numpy as np
import torch

from repro_torch.checkpoint import io as checkpoint_io
from repro_torch.convert import goss_draws_from_numpy, masks_from_numpy
from repro_torch.core import backend as backend_mod
from repro_torch.core import boosting, metrics
from repro_torch.core import forest as forest_mod
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core.types import (
    EnsembleModel,
    TreeConfig,
    pack_ensemble,
    unpack_ensemble,
)
from repro_torch.data import synthetic, tabular
from repro_torch.device import resolve
from repro_torch.federation import chaos as chaos_mod
from repro_torch.federation import compress, gradientless
from repro_torch.federation import runtime as runtime_mod
from repro_torch.obs import log as obs_log
from repro_torch.obs import perfetto
from repro_torch.obs import trace as obs_trace


def make_config(model: str, rounds: int, tree: TreeConfig):
    """The launcher's ``--model`` presets, as the JAX launcher builds them."""
    return {
        "dynamic_fedgbf": lambda: boosting.dynamic_fedgbf_config(
            rounds, tree=tree),
        "fedgbf": lambda: boosting.FedGBFConfig(
            rounds=rounds, tree=tree, n_trees_max=5, n_trees_min=5,
            rho_id_min=0.3, rho_id_max=0.3),
        "secureboost": lambda: boosting.secureboost_config(rounds, tree=tree),
        "federated_forest": lambda: boosting.federated_forest_config(
            n_trees=rounds, tree=tree),
    }[model]()


def _stitch_models(prefix_model, models: list) -> EnsembleModel:
    """The resumed prefix (if any) and the chunk models as one ensemble;
    all pieces share the same deterministic bin edges."""
    pieces = ([prefix_model] if prefix_model is not None else []) + models
    head = pieces[0]
    return EnsembleModel(
        forests=tuple(f for m in pieces for f in m.forests),
        learning_rate=head.learning_rate, base_score=head.base_score,
        bin_edges=head.bin_edges, loss=head.loss, max_depth=head.max_depth)


def _merge_histories(hists: list) -> boosting.TrainHistory:
    """Per-chunk histories (contiguous round windows) as one."""
    if len(hists) == 1:
        return hists[0]
    out = boosting.TrainHistory(start_round=hists[0].start_round)
    for h in hists:
        for f in ("rounds", "train", "valid", "n_trees", "rho_id",
                  "wall_time_s", "segments"):
            getattr(out, f).extend(getattr(h, f))
        out.overhead_s += h.overhead_s
    out.final_margin = hists[-1].final_margin
    out.final_margin_valid = hists[-1].final_margin_valid
    return out


def _load_masks(path: str, sampling: str, device):
    """The draws of a ``--masks`` file: ``StepMasks`` from ``sample_bits``
    (bit-packed rows), ``feature`` and ``n``, or under GOSS ``GossDraws``
    from ``uniform`` and ``feature``."""
    z = np.load(path)
    if sampling == "goss":
        return goss_draws_from_numpy(z["uniform"], z["feature"],
                                     device=device)
    return masks_from_numpy(z["sample_bits"], z["feature"], device=device,
                            n=int(z["n"]))


def _fingerprint(args, cfg, parties=None) -> str:
    """The configuration a train state belongs to: everything that decides
    the trees, nothing that decides only where they are built (``--device``
    and ``--backend`` are left out).  A federated run adds its party count,
    which decides the padded width and so the masks; party dropout adds its
    schedule's parameters."""
    masks_sha = None
    if args.masks:
        with open(args.masks, "rb") as f:
            masks_sha = hashlib.sha256(f.read()).hexdigest()
    extra = {} if parties is None else {"parties": parties}
    if args.party_dropout > 0:
        extra.update(party_dropout=args.party_dropout,
                     dropout_seed=args.dropout_seed,
                     retry_max=args.retry_max)
    return json.dumps({
        **extra,
        "dataset": args.dataset, "model": args.model, "rounds": cfg.rounds,
        "loss": cfg.loss, "sampling": cfg.sampling,
        "max_depth": args.max_depth, "n": args.n,
        "hist_subtraction": args.hist_subtraction,
        "max_active_nodes": args.max_active_nodes,
        "shared_root": args.shared_root, "masks_sha256": masks_sha,
    }, sort_keys=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=list(synthetic.DATASETS),
                    default="default_credit_card")
    ap.add_argument("--model", choices=["dynamic_fedgbf", "fedgbf",
                                        "secureboost", "federated_forest"],
                    default="dynamic_fedgbf")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--loss", default="logistic",
                    help="objective registry name: logistic, squared, "
                         "softmax<K>, quantile[@alpha]")
    ap.add_argument("--n", type=int, default=0, help="subsample dataset")
    ap.add_argument("--max-depth", type=int, default=3)
    ap.add_argument("--backend", default="local-cuda",
                    choices=backend_mod.available_backends(),
                    help="named TreeBackend: local-cuda runs the histogram "
                         "kernel, local the plain PyTorch providers, vfl-* "
                         "the parties as column blocks (one kernel launch a "
                         "level for all of them)")
    ap.add_argument("--parties", type=int, default=2,
                    help="party count for vfl-* backends")
    ap.add_argument("--data-shards", type=int, default=0,
                    help="row shards of a vfl-*-sharded backend: contiguous "
                         "row blocks on the one card, one histogram launch "
                         "a level for every (party, shard) block, the "
                         "partials summed in shard order; uneven n pads "
                         "with weight-0 rows inside the backend.  0 = 1")
    ap.add_argument("--engine", default="scan", choices=("scan", "loop"),
                    help="training engine: the port has one, with the JAX "
                         "scan engine's contract; 'loop' is refused")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (no silent CPU fallback)")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="evaluate metrics every k rounds (and at the last)")
    ap.add_argument("--sampling", default="uniform",
                    choices=("uniform", "goss"),
                    help="rho_id sample policy: uniform (paper eq. 4) or "
                         "GOSS (top-|g| + amplified random rest)")
    ap.add_argument("--hist-subtraction",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="levels >= 1 accumulate only left children and "
                         "derive the siblings as parent - left")
    ap.add_argument("--max-active-nodes", type=int, default=0,
                    help="frontier-compaction budget per level (0 = none)")
    ap.add_argument("--shared-root", action="store_true",
                    help="level 0 as one unmasked histogram minus per-tree "
                         "deltas, in rounds that keep >= half the rows "
                         "(uniform sampling only)")
    ap.add_argument("--masks", default=None, metavar="PATH.npz",
                    help="take every tree build's masks (GOSS: draws) from "
                         "this file (e.g. the JAX package's draws)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome-trace/Perfetto JSON timeline")
    ap.add_argument("--log-json", action="store_true",
                    help="one structured JSON line per round instead of "
                         "the [round NNN] prints")
    ap.add_argument("--chaos-drop", type=float, default=0.0,
                    help="chaos transport: probability a level-exchange "
                         "transmission attempt is dropped (detected by "
                         "checksum and retransmitted; trees unchanged)")
    ap.add_argument("--chaos-corrupt", type=float, default=0.0,
                    help="chaos transport: probability an attempt has one "
                         "bit flipped in flight")
    ap.add_argument("--chaos-dup", type=float, default=0.0,
                    help="chaos transport: probability the final delivery "
                         "is duplicated")
    ap.add_argument("--chaos-delay", type=float, default=0.0,
                    help="chaos transport: probability the final delivery "
                         "is delayed (an event only)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the chaos fault plan")
    ap.add_argument("--chaos-max-retries", type=int, default=3,
                    help="retransmission budget per exchange slot")
    ap.add_argument("--party-dropout", type=float, default=0.0,
                    help="probability a party misses a coordinator poll; a "
                         "party missing 1 + --retry-max polls is degraded "
                         "for the round (its columns leave the split "
                         "search)")
    ap.add_argument("--dropout-seed", type=int, default=0,
                    help="seed of the party-availability draw")
    ap.add_argument("--retry-max", type=int, default=3,
                    help="coordinator re-polls (exponential backoff, "
                         "simulated) before degrading a silent party")
    ap.add_argument("--dropout-fallback", default="none",
                    choices=("none", "gradientless"),
                    help="gradientless: every party degraded in >= 1 round "
                         "also fits party-local gradient-less trees, whose "
                         "margins are added at test evaluation")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="train-state checkpoint path (atomic npz + sha256 "
                         "sidecar); every chunk's end writes here")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="checkpoint the train state every N rounds (0 = "
                         "only at --stop-after-round / completion)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint: the finished ensemble "
                         "is byte-identical to an uninterrupted run's")
    ap.add_argument("--stop-after-round", type=int, default=0, metavar="K",
                    help="stop (and checkpoint) after absolute round K")
    args = ap.parse_args(argv)
    if args.engine == "loop":
        raise SystemExit(
            "--engine loop: the port has one training engine, with the scan "
            "engine's contract (segments, masks up front); use --engine scan")

    device = resolve(args.device)
    tracer = obs_trace.Tracer() if args.trace else obs_trace.NULL_TRACER
    obs_trace.set_global_tracer(tracer)
    ds = synthetic.load(args.dataset, n=args.n or None)
    tree = TreeConfig(max_depth=args.max_depth, num_bins=32,
                      hist_subtraction=args.hist_subtraction,
                      max_active_nodes=args.max_active_nodes,
                      shared_root=args.shared_root)
    cfg = make_config(args.model, args.rounds, tree)
    if args.sampling != cfg.sampling:
        cfg = dataclasses.replace(cfg, sampling=args.sampling)
    if args.loss != cfg.loss:
        cfg = dataclasses.replace(cfg, loss=args.loss)
    obj = objective_mod.get_objective(cfg.loss)

    # chaos transport: rates > 0 select the -chaos twin of the backend; a
    # -chaos name with no rates runs the zero-fault spec (checksums only)
    backend_name = args.backend
    chaos_rates = (args.chaos_drop, args.chaos_corrupt, args.chaos_dup,
                   args.chaos_delay)
    if any(r > 0 for r in chaos_rates) and not backend_name.endswith(
            "-chaos"):
        backend_name += "-chaos"
    federated = backend_name.startswith("vfl")
    chaos = None
    if backend_name.endswith("-chaos"):
        if not federated:
            raise SystemExit(
                f"chaos transport needs a vfl-* backend, got {args.backend!r}")
        chaos = chaos_mod.ChaosSpec(
            drop=args.chaos_drop, corrupt=args.chaos_corrupt,
            dup=args.chaos_dup, delay=args.chaos_delay,
            seed=args.chaos_seed, max_retries=args.chaos_max_retries)
        print(f"chaos transport: {chaos.tag} (faults are injected, detected "
              "by checksum and retransmitted — results stay bit-identical)")
    sharded = "-sharded" in backend_name
    if args.data_shards < 0:
        raise SystemExit(f"--data-shards must be >= 0, got "
                         f"{args.data_shards}")
    shards = args.data_shards or 1
    if shards > 1 and not sharded:
        raise SystemExit(
            f"--data-shards {shards}: the data shards are row blocks of "
            f"one card and need a -sharded backend (e.g. "
            f"{backend_name.replace('-chaos', '')}-sharded), not "
            f"{backend_name!r}")
    x_train, x_test = np.asarray(ds.x_train), np.asarray(ds.x_test)
    ledger = None
    aggregation = None
    if federated:
        x_train, d_pad = tabular.pad_features(x_train, args.parties)
        x_test, _ = tabular.pad_features(x_test, args.parties)
        if sharded and x_train.shape[0] % shards:
            print(f"sharded backend: n={x_train.shape[0]} pads to "
                  f"{-(-x_train.shape[0] // shards) * shards} inside the "
                  f"backend ({shards} sample shards, weight-0 rows)")
        bk_kw = {"chaos": chaos} if chaos is not None else {}
        if sharded:
            bk_kw["data_shards"] = shards
        backend = backend_mod.get_backend(backend_name, tree=tree,
                                          num_parties=args.parties, **bk_kw)
        desc = backend.descriptor
        aggregation = "argmax" if "argmax" in desc.impl else "histogram"
        print(f"backend={backend.name}: {args.parties} parties x {shards} "
              f"data shards, aggregation={aggregation}, "
              f"transport={desc.transport}"
              + (", async exchange" if desc.async_exchange else ""))
        ledger = compress.reconciled_ledger(
            args.parties, tree, cfg, aggregation=aggregation,
            transport=desc.transport_spec, n_samples=x_train.shape[0],
            num_features=d_pad, async_exchange=desc.async_exchange,
            n_channels=obj.n_classes, chaos=chaos,
            data_shards=shards if sharded else 0)
        cost = ledger.predicted_paillier()
        print(f"paillier-model bytes (ledger): {cost.total/1e6:.1f} MB "
              f"{cost.breakdown()}")
        rec = ledger.reconcile()
        print(f"wire bytes: measured={rec['total']['measured']/1e6:.1f} MB "
              f"predicted={rec['total']['predicted']/1e6:.1f} MB "
              f"(match={rec['total']['match']})")
    else:
        backend = backend_name
    n, d = x_train.shape

    # party dropout: the degraded (round, party) cells' columns leave the
    # round's split search
    dropout_sched = None
    round_mask = None
    if args.party_dropout > 0:
        dropout_sched = runtime_mod.dropout_schedule(
            args.party_dropout, cfg.rounds, args.parties,
            seed=args.dropout_seed,
            policy=runtime_mod.RetryPolicy(max_retries=args.retry_max))
        round_mask = runtime_mod.degradation_masks(
            dropout_sched.degraded, d, args.parties)
        print(f"party-dropout: {dropout_sched.degraded_rounds}/{cfg.rounds} "
              f"degraded rounds, {int(dropout_sched.retries.sum())} retries, "
              f"simulated backoff {dropout_sched.backoff_s:.2f}s")
    if args.masks:
        masks = _load_masks(args.masks, cfg.sampling, device)
    else:  # the whole schedule's draws, so a resumed run replays them
        masks = forest_mod.draw_step_masks(cfg, n, d,
                                           prng.PRNGKey(0, device))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"backend={backend_name} on {where}: {n} x {d} rows, "
          f"sampling={cfg.sampling}, masks "
          f"{'from ' + args.masks if args.masks else 'drawn from PRNGKey(0)'}")

    fingerprint = _fingerprint(args, cfg,
                               args.parties if federated else None)
    start = 0
    margin_carry = None
    prefix_model = None
    if args.resume:
        if not args.checkpoint:
            raise SystemExit("--resume needs --checkpoint PATH")
        state = checkpoint_io.load_train_state(args.checkpoint, device=device)
        if state["config_fingerprint"] != fingerprint:
            raise SystemExit(
                "--resume: checkpoint was written by a different training "
                "configuration (fingerprint mismatch)")
        start = int(state["completed_rounds"])
        margin_carry = state["margin"]
        prefix_model = unpack_ensemble(state["packed"])
        print(f"resume: {start} completed rounds restored from "
              f"{args.checkpoint}")
    stop_limit = args.stop_after_round or cfg.rounds
    if not start < stop_limit <= cfg.rounds:
        raise SystemExit(f"--stop-after-round must be in ({start}, "
                         f"{cfg.rounds}]")

    chunk = args.checkpoint_every or (stop_limit - start)
    models, hists = [], []
    a = start
    while a < stop_limit:
        b = min(a + chunk, stop_limit)
        model_c, hist_c = boosting.train_fedgbf(
            x_train, ds.y_train, cfg, masks=masks, backend=backend,
            eval_every=args.eval_every, verbose=not args.log_json,
            tracer=tracer, device=device, round_feature_mask=round_mask,
            start_round=a, stop_round=b, init_margin=margin_carry)
        models.append(model_c)
        hists.append(hist_c)
        margin_carry = hist_c.final_margin
        a = b
        if args.checkpoint:
            checkpoint_io.save_train_state(
                args.checkpoint, _stitch_models(prefix_model, models),
                margin=margin_carry, completed_rounds=a,
                fingerprint=fingerprint)
            print(f"checkpoint: {a} rounds -> {args.checkpoint}")
    model = _stitch_models(prefix_model, models)
    hist = _merge_histories(hists)
    print(f"engine={hist.engine}: total train wall "
          f"{hist.total_wall_time_s:.2f}s over {len(hist.n_trees)} rounds")
    if args.stop_after_round:
        print(f"stopped after round {stop_limit} (checkpointed); re-run "
              "with --resume to continue")
    per_round_bytes = None
    if ledger is not None:
        # the ledger's rows cover the full schedule: clip to this window
        per_round_bytes = ledger.per_round_measured()[
            start:start + len(hist.n_trees)]
    faults = None
    if (args.log_json or args.trace) and (chaos is not None
                                          or dropout_sched is not None):
        faults = [dict() for _ in range(len(hist.n_trees))]
        if chaos is not None:
            plan = chaos_mod.plan_summary(
                chaos, chaos_mod.n_slots_per_tree(aggregation,
                                                  args.max_depth))
            for r in faults:  # every round makes the same slots
                for key in ("faults_injected", "retries", "dropped",
                            "corrupted"):
                    r[key] = plan[key]
        if dropout_sched is not None:
            for i, r in enumerate(faults):
                summary = dropout_sched.round_summary(start + i)
                r["retries"] = r.get("retries", 0) + summary["retries"]
                r["degraded_parties"] = summary["degraded_parties"]
    if args.log_json:
        for line in obs_log.render_round_lines(hist, per_round_bytes,
                                               faults):
            print(line)
    if args.trace:
        perfetto.add_training_timeline(tracer, hist, per_round_bytes, faults)
        n_events = perfetto.export_chrome_trace(
            args.trace, tracer,
            metadata={"dataset": args.dataset, "backend": backend_name,
                      "engine": hist.engine, "rounds": args.rounds})
        print(f"trace: {n_events} events -> {args.trace}")
    packed = pack_ensemble(model)
    x_test = torch.as_tensor(x_test, device=device)
    y_test = torch.as_tensor(np.asarray(ds.y_test), device=device)
    margin = boosting.predict(packed, x_test)
    if args.dropout_fallback == "gradientless" and dropout_sched is not None:
        # every party degraded in >= 1 round also fits party-local
        # gradient-less trees; their contributions (margin minus base) add
        # onto the ensemble's test margin
        for p in runtime_mod.degraded_parties(dropout_sched):
            sl = runtime_mod.party_column_slice(p, d, args.parties)
            gl_model, _ = gradientless.train_gradientless(
                x_train[:, sl], ds.y_train, cfg, prng.PRNGKey(1000 + p),
                num_parties=1, device=device)
            margin = margin + (boosting.predict(gl_model, x_test[:, sl])
                               - gl_model.base_score)
            print(f"gradientless fallback: party {p} "
                  f"({gl_model.total_trees} local trees) added to margin")
    if obj.n_classes > 1:
        rep = metrics.multiclass_report(y_test, margin)
        print(f"TEST: acc={rep['acc']:.4f} macro_f1={rep['macro_f1']:.4f} "
              f"(total trees: {packed.total_trees}, K={obj.n_classes})")
    else:
        rep = metrics.classification_report(y_test, margin)
        print(f"TEST: auc={rep['auc']:.4f} acc={rep['acc']:.4f} "
              f"f1={rep['f1']:.4f} (total trees: {packed.total_trees})")


if __name__ == "__main__":
    main()
