"""Quickstart: train Dynamic FedGBF and SecureBoost on credit data, compare
quality and the paper's runtime bounds: the port of
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Training runs on ``local-cuda`` (the histogram kernel; on CPU tensors its
plain version) and scoring on ``fused-cuda``; the masks are drawn from
``PRNGKey(0)``, as the JAX script draws them, so the models are the JAX
script's.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import (boosting, explain, metrics, prng,
                              runtime_model)
from repro_torch.data import synthetic, tabular
from repro_torch.device import resolve


def main(device="cuda", n: int = 10_000, rounds: int = 15) -> dict:
    """Returns ``{name: classification report}`` of both models, with the
    Dynamic FedGBF model's top features and party importance and the
    runtime bounds."""
    device = resolve(device)
    # 1. Data: credit-default stand-in (~22% positives; the paper's shape).
    ds = synthetic.load("default_credit_card", n=n)
    x_test = torch.from_numpy(ds.x_test).to(device)
    y_test = torch.from_numpy(ds.y_test).to(device)

    # 2. Dynamic FedGBF (Alg. 3): forests of 5 -> 2 trees per boosting
    #    round, sample rate 0.1 -> 0.3 (the paper's schedules).
    cfg = boosting.dynamic_fedgbf_config(rounds=rounds)
    model, _ = boosting.train_fedgbf(ds.x_train, ds.y_train, cfg,
                                     prng.PRNGKey(0), backend="local-cuda",
                                     device=device, verbose=True)

    # 3. Baseline: SecureBoost == FedGBF degenerated to 1 tree / round.
    sb_cfg = boosting.secureboost_config(rounds=rounds)
    sb_model, _ = boosting.train_fedgbf(ds.x_train, ds.y_train, sb_cfg,
                                        prng.PRNGKey(0), backend="local-cuda",
                                        device=device)

    # 4. Compare quality (the paper's Tables 2-3 metrics).
    out = {}
    for name, m in [("dynamic_fedgbf", model), ("secureboost", sb_model)]:
        rep = metrics.classification_report(
            y_test, boosting.predict(m, x_test, impl="fused-cuda"))
        out[name] = rep
        print(f"{name:16s} test auc={rep['auc']:.4f} acc={rep['acc']:.4f} "
              f"f1={rep['f1']:.4f} trees={m.total_trees}")

    # 4b. Explainability (why finance keeps tree models).
    imp = explain.feature_importance(model, ds.x_train.shape[1])
    part = tabular.partition_from_dims([13, 10])  # the paper's Table 1 split
    out["top_features"] = sorted(range(len(imp)), key=lambda i: -imp[i])[:3]
    out["party_importance"] = explain.party_importance(model, part)
    print("top-3 features by gain:", out["top_features"],
          "| per-party importance:", out["party_importance"])

    # 5. The runtime model (eqs. 8-11): FedGBF's per-round forests cost
    #    [sum a_i b_i, sum N_i a_i b_i] tree-units vs SecureBoost's M units.
    fg = runtime_model.estimate_fedgbf_runtime(cfg, 1.0)
    sb = runtime_model.estimate_secureboost_runtime(rounds, 1.0)
    out["runtime_units"] = {"fedgbf": (fg.lower_s, fg.upper_s),
                            "secureboost": sb}
    print(f"runtime bounds (tree-units): FedGBF=[{fg.lower_s:.2f}, "
          f"{fg.upper_s:.2f}] vs SecureBoost={sb:.2f} -> ideal-parallel "
          f"saving {1 - fg.lower_s / sb:.0%}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
