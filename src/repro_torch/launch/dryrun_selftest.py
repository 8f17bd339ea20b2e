"""Dry-run smoke: the train, prefill and decode steps of six smoke configs
(every block family) counted on ``meta`` tensors against the (4, 2)
abstract mesh of ``make_test_mesh(8)``, in this process, each recording its
activation anchors' specs: the counterpart of
``repro/launch/dryrun_selftest.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_selftest
"""

from __future__ import annotations

import sys

from repro_torch.configs import get_smoke_config
from repro_torch.launch import costmodel
from repro_torch.launch import shapes as shapes_mod
from repro_torch.launch.mesh import make_test_mesh

SMOKE_SPECS = [
    shapes_mod.ShapeSpec("smoke_train", "train", 64, 8),
    shapes_mod.ShapeSpec("smoke_prefill", "prefill", 64, 8),
    shapes_mod.ShapeSpec("smoke_decode", "decode", 64, 8),
]

# smoke subset spanning all families
ARCHS = ["smollm-135m", "gemma2-2b", "zamba2-7b", "rwkv6-7b",
         "granite-moe-3b-a800m", "whisper-large-v3"]


def main(argv=None) -> int:
    mesh = make_test_mesh(8)
    failures = 0
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        for spec in SMOKE_SPECS:
            try:
                cost = costmodel.count_step(cfg, spec, mesh)
                if not cost["flops"] > 0:
                    raise ValueError(f"counted {cost['flops']} FLOPs")
                if not cost["activation_specs"]:
                    raise ValueError("no activation anchor recorded")
                print(f"OK {arch} {spec.name} flops/dev={cost['flops']:.3e}"
                      f" args/dev={cost['argument_bytes']:,}")
            except Exception as e:  # noqa: BLE001 — failures ARE the output
                failures += 1
                print(f"FAIL {arch} {spec.name}: {type(e).__name__}: "
                      f"{str(e)[:200]}")
    print("DRYRUN SELFTEST " + ("FAILED" if failures else "PASSED"))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
