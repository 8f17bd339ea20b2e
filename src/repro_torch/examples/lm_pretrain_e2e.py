"""End-to-end LM pretraining: SmolLM-135M for a few hundred steps on the
synthetic token pipeline, the loss dropping: the port of
``examples/lm_pretrain_e2e.py``.

The full config (30 layers, d_model 576, ~134M params) by default; with
``--quick`` the reduced one.

    PYTHONPATH=src python -m repro_torch.examples.lm_pretrain_e2e \
        [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.launch import train as train_driver


def main(device="cuda", quick: bool = False, steps: int | None = None
         ) -> dict:
    """Runs ``launch.train`` as the JAX script does (``steps`` overrides
    its step count); returns its ``{"state", "losses", "walls"}``."""
    if quick:
        argv = ["--arch", "smollm-135m", "--smoke", "--steps", "60",
                "--batch", "8", "--seq", "128"]
    else:
        argv = ["--arch", "smollm-135m", "--steps", "300", "--batch", "4",
                "--seq", "256", "--log-every", "20"]
    if steps is not None:
        argv[argv.index("--steps") + 1] = str(steps)
    return train_driver.run(train_driver.parse_args(
        argv + ["--device", str(device)]))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.device, quick=args.quick)
