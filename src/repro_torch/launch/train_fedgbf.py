"""FedGBF training driver on the local backends: the counterpart of
``repro/launch/train_fedgbf.py``.

    # on the card (the defaults: --backend local-cuda --device cuda)
    PYTHONPATH=src python -m repro_torch.launch.train_fedgbf --rounds 20

    # on the CPU, through the kernel's plain version or the plain providers
    PYTHONPATH=src python -m repro_torch.launch.train_fedgbf --device cpu \
        --rounds 3 --n 2000 [--backend local]

Masks: by default each scheduled tree build's masks are drawn natively
from seed 0 (the JAX package's keep-counts, not its draws).  ``--masks
PATH.npz`` takes the JAX package's draws instead (``sample_bits`` as
``np.packbits`` rows, ``feature``, ``n``; the format of
``testdata/dynamic_fedgbf_r20_train.npz``), and then the printed history
reconciles with the JAX launcher's.  ``--checkpoint PATH`` saves the packed
model in the checkpoint format both packages read.  The federated backends,
GOSS and the resume window come with later slices.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import io as checkpoint_io
from repro_torch.convert import masks_from_numpy
from repro_torch.core import backend as backend_mod
from repro_torch.core import boosting, metrics
from repro_torch.core import objective as objective_mod
from repro_torch.core.types import TreeConfig, pack_ensemble
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
    ap.add_argument("--hist-subtraction",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="levels >= 1 accumulate only left children and "
                         "derive the siblings as parent - left")
    ap.add_argument("--max-active-nodes", type=int, default=0,
                    help="frontier-compaction budget per level (0 = none)")
    ap.add_argument("--shared-root", action="store_true",
                    help="level 0 as one unmasked histogram minus per-tree "
                         "deltas, in rounds that keep >= half the rows")
    ap.add_argument("--masks", default=None, metavar="PATH.npz",
                    help="take every tree build's masks from this file "
                         "(e.g. the JAX package's draws)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome-trace/Perfetto JSON timeline")
    ap.add_argument("--log-json", action="store_true",
                    help="one structured JSON line per round instead of "
                         "the [round NNN] prints")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="save the trained packed model here")
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
    if args.loss != cfg.loss:
        cfg = dataclasses.replace(cfg, loss=args.loss)
    obj = objective_mod.get_objective(cfg.loss)

    masks = None
    if args.masks:
        z = np.load(args.masks)
        masks = masks_from_numpy(z["sample_bits"], z["feature"],
                                 device=device, n=int(z["n"]))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"backend={args.backend} on {where}: {ds.x_train.shape[0]} x "
          f"{ds.x_train.shape[1]} rows, masks "
          f"{'from ' + args.masks if args.masks else 'drawn from seed 0'}")
    model, hist = boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, masks, backend=args.backend,
        eval_every=args.eval_every, verbose=not args.log_json,
        tracer=tracer, device=device)
    print(f"engine={hist.engine}: total train wall "
          f"{hist.total_wall_time_s:.2f}s over {len(hist.n_trees)} rounds")
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
    if args.checkpoint:
        checkpoint_io.save_ensemble(args.checkpoint, packed)
        print(f"saved packed checkpoint to {args.checkpoint}")
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
