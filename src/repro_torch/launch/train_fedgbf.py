"""FedGBF training driver on the local backends: the counterpart of
``repro/launch/train_fedgbf.py``.

    # on the card (the defaults: --backend local-cuda --device cuda)
    PYTHONPATH=src python -m repro_torch.launch.train_fedgbf --rounds 20

    # on the CPU, through the kernel's plain version or the plain providers
    PYTHONPATH=src python -m repro_torch.launch.train_fedgbf --device cpu \
        --rounds 3 --n 2000 [--backend local] [--sampling goss]

    # kill and resume: checkpoint the train state every N rounds (atomic
    # npz + sha256 sidecar, the JAX package's layout), stop after round K,
    # resume to the bytes of an uninterrupted run
    ... --checkpoint ckpt/run --checkpoint-every 2 --stop-after-round 3
    ... --checkpoint ckpt/run --checkpoint-every 2 --resume

Masks: by default every scheduled tree build's masks (under ``--sampling
goss``: its uniforms and feature masks) are drawn natively from seed 0 on
the CPU (the JAX package's keep-counts, not its draws), for the whole
schedule, so a resumed run replays them.  ``--masks PATH.npz`` takes the
JAX package's draws instead: ``sample_bits`` as ``np.packbits`` rows,
``feature`` and ``n`` (the format of
``testdata/dynamic_fedgbf_r20_train.npz``), or under GOSS ``uniform`` and
``feature``; then the printed history reconciles with the JAX launcher's.
``--checkpoint PATH`` is the train-state path, as in the JAX launcher; the
packed model for serving comes from ``serve_fedgbf --save``.  A state
written on the card resumes on the CPU and the reverse: the fingerprint
leaves out ``--device`` and ``--backend``.  The federated backends come
with a later slice.
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
from repro_torch.core.types import (
    EnsembleModel,
    TreeConfig,
    pack_ensemble,
    unpack_ensemble,
)
from repro_torch.data import synthetic
from repro_torch.device import resolve
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


def _fingerprint(args, cfg) -> str:
    """The configuration a train state belongs to: everything that decides
    the trees, nothing that decides only where they are built (``--device``
    and ``--backend`` are left out)."""
    masks_sha = None
    if args.masks:
        with open(args.masks, "rb") as f:
            masks_sha = hashlib.sha256(f.read()).hexdigest()
    return json.dumps({
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
                         "kernel, local the plain PyTorch providers")
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

    n, d = ds.x_train.shape
    if args.masks:
        masks = _load_masks(args.masks, cfg.sampling, device)
    else:  # the whole schedule's draws, so a resumed run replays them
        masks = forest_mod.draw_step_masks(cfg, n, d,
                                           torch.Generator().manual_seed(0))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"backend={args.backend} on {where}: {n} x {d} rows, "
          f"sampling={cfg.sampling}, masks "
          f"{'from ' + args.masks if args.masks else 'drawn from seed 0'}")

    fingerprint = _fingerprint(args, cfg)
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
            ds.x_train, ds.y_train, cfg, masks, backend=args.backend,
            eval_every=args.eval_every, verbose=not args.log_json,
            tracer=tracer, device=device, start_round=a, stop_round=b,
            init_margin=margin_carry)
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
    if args.log_json:
        for line in obs_log.render_round_lines(hist):
            print(line)
    if args.trace:
        perfetto.add_training_timeline(tracer, hist)
        n_events = perfetto.export_chrome_trace(
            args.trace, tracer,
            metadata={"dataset": args.dataset, "backend": args.backend,
                      "engine": hist.engine, "rounds": args.rounds})
        print(f"trace: {n_events} events -> {args.trace}")
    packed = pack_ensemble(model)
    x_test = torch.as_tensor(np.asarray(ds.x_test), device=device)
    y_test = torch.as_tensor(np.asarray(ds.y_test), device=device)
    margin = boosting.predict(packed, x_test)
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
