"""Production-shape dry-run of the LM substrate: the counterpart of
``repro/launch/dryrun.py``.

For every (architecture x input shape) combination on the production mesh,
(16, 16) single pod or (2, 16, 16) multi-pod, the JAX package lowers and
compiles the sharded step and reads XLA's memory and cost analyses.  The
port runs the step whole on ``meta`` tensors (shapes and dtypes, no
storage, nothing allocated) under ``tools.roofline.CostCounter``: that is
its "lowers at production shape".  It reports:

* ``memory``: argument bytes per device, exact from the partition specs
  (``launch/shardings.py``; each leaf's bytes over its shard count); the
  counter's peak of live storage (temp) over the chips; their sum (peak);
  the outputs the step allocates over the chips;
* ``roofline`` from the whole counted program (``costing``
  ``"whole-program"``: the counter sees every unit, so the JAX package's
  compositional formula has nothing to add; ``launch/costmodel.py``);
* ``collectives_program``: ``roofline.collective_stats``'s rule on the
  whole program;
* ``activation_specs``: the spec each activation anchor of the forward
  (``models/partition.py``) builds for the mesh, distinct ones with their
  counts.

Usage (on ``meta``: no device is needed or used):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Reports go to ``reports/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Callable

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import costmodel
from repro_torch.launch import shapes as shapes_mod
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.launch.shardings import (
    batch_spec,
    cache_spec,
    param_spec,
    shard_count,
)
from repro_torch.tools import roofline as roofline_mod

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")


@dataclasses.dataclass
class Step:
    """A step on ``meta`` inputs: ``run()`` runs it once; ``arguments``
    holds ``(tensor, spec)`` for every argument leaf; ``leaves`` the
    parameters as the collective rule sees them."""

    run: Callable[[], object]
    kind: str
    mesh: AbstractMesh
    arguments: list
    leaves: list
    act_itemsize: int
    remat: bool

    def argument_bytes(self) -> int:
        """Bytes of the arguments a device holds (each leaf over its
        shards)."""
        return sum(t.numel() * t.element_size() // shard_count(spec,
                                                               self.mesh)
                   for t, spec in self.arguments)

    def collectives(self) -> roofline_mod.CollectiveStats:
        return roofline_mod.collective_stats(
            self.leaves, self.mesh, self.kind, self.act_itemsize, self.remat)


def _param_entries(cfg, spec, model, mesh) -> tuple[list, list]:
    """(arguments, rule leaves) of ``model``'s parameters, stacked as the
    JAX tree stacks them."""
    from repro_torch import convert

    B = spec.global_batch
    rows = B * (1 if spec.kind == "decode" else spec.seq_len)
    apps = costmodel.num_shared_apps(cfg)
    arguments, leaves = [], []
    for path, leaf in convert._jax_pairs(model):
        shape = tuple(leaf.shape)
        arguments.append((leaf, param_spec(path, shape, mesh)))
        r, uses = rows, 1
        if path[0] == "encoder":
            r, uses = B * cfg.encoder.num_frames, int(spec.kind != "decode")
        elif path[0] == "shared":
            uses = apps
        elif "moe" in path:
            r = rows * cfg.moe.top_k
        leaves.append(roofline_mod.LeafUse(path, shape, leaf.element_size(),
                                           r, uses))
    return arguments, leaves


def _batch_args(inputs: dict, mesh) -> list:
    return [(t, batch_spec(mesh, t.dim(), t.shape[0]))
            for t in inputs.values()]


def build_step(cfg, spec, mesh) -> Step:
    """The train step, prefill or decode step of ``cfg`` at ``spec`` (a
    ``shapes.ShapeSpec``: one of ``SHAPES`` or any custom one) on
    ``meta`` inputs."""
    from repro_torch.models import train as train_mod
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.model import LMModel

    inputs = shapes_mod.input_specs_for(cfg, spec)
    model = LMModel(cfg, device="meta")
    arguments, leaves = _param_entries(cfg, spec, model, mesh)
    act = dtype_of(cfg.compute_dtype).itemsize
    common = dict(kind=spec.kind, mesh=mesh, leaves=leaves,
                  act_itemsize=act, remat=cfg.remat)
    # the model's index dtype; the specs keep the JAX int32
    as_index = {k: v.long() if k in ("tokens", "labels") else v
                for k, v in inputs.items()}

    if spec.kind == "train":
        state = train_mod.init_train_state(None, cfg, model=model)
        step = train_mod.make_train_step(cfg)
        moments = arguments * 2                   # m and v mirror the params
        step_count = (torch.empty((), dtype=torch.int32, device="meta"), ())
        return Step(run=lambda: step(state, as_index),
                    arguments=arguments + moments + [step_count]
                    + _batch_args(inputs, mesh), **common)

    if spec.kind == "prefill":
        stubs = {k: v for k, v in as_index.items() if k != "tokens"}

        @torch.no_grad()
        def prefill():
            return model.prefill(as_index["tokens"], **stubs)

        return Step(run=prefill, arguments=arguments
                    + _batch_args(inputs, mesh), **common)

    cache = inputs["cache"]
    token = inputs["token"].long()
    pos = spec.seq_len - 1

    @torch.no_grad()
    def decode():
        return model.decode_step(cache, token, pos)

    cache_args = [(t, cache_spec(path, (len(ts),) + tuple(t.shape), mesh))
                  for path, ts in LMModel.jax_cache_leaves(cache)
                  for t in ts]
    # a unit's own cache leaf is the stacked leaf's 1/U: its spec's shard
    # count applies to each
    return Step(run=decode, arguments=arguments + cache_args
                + [(inputs["token"], batch_spec(mesh, 2, spec.global_batch)),
                   (inputs["pos"], ())], **common)


def _configure(arch: str):
    cfg = get_config(arch)
    moe_impl = os.environ.get("REPRO_MOE_IMPL")
    if moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=moe_impl))
    return cfg


def run_one(arch: str, shape, multi_pod: bool, save: bool = True,
            variant: str = "",
            mesh: AbstractMesh | None = None, cfg=None) -> dict:
    """Dry-run one (arch, shape) on the production mesh (or ``mesh``; a
    ``cfg`` replaces the registry's).  ``shape`` is a name of ``SHAPES``
    or a ``ShapeSpec``.  Returns the report."""
    spec = shapes_mod.SHAPES[shape] if isinstance(shape, str) else shape
    shape_name = spec.name
    ok, reason = shapes_mod.applicable(arch, shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if mesh is not None:
        mesh_name = "x".join(str(s) for s in mesh.shape.values())
    tag = f"{arch}__{shape_name}__{mesh_name}" + (
        f"__{variant}" if variant else "")
    if not ok:
        report = {"tag": tag, "status": "skipped", "reason": reason}
        _save(report, tag, save)
        print(f"[SKIP] {tag}: {reason}")
        return report

    cfg = cfg if cfg is not None else _configure(arch)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    chips = mesh.size

    t0 = time.time()
    try:
        step = costmodel.count_step(cfg, spec, mesh)
        t_count = time.time() - t0
        argument = step["argument_bytes"]
        roof = roofline_mod.roofline_from_costs(step, cfg, spec, chips)
        coll = step["collectives"]
        report = {
            "tag": tag,
            "status": "ok",
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_name,
            "chips": chips,
            "count_s": round(t_count, 2),
            "memory": {
                "argument_bytes_per_device": argument,
                "temp_bytes_per_device": step["peak"],
                "peak_bytes_per_device": argument + step["peak"],
            },
            "roofline": roof.as_dict(),
            "costing": "whole-program",
            "counted_ops": step["ops"],
            "collectives_program": {
                "bytes_by_kind": coll.bytes_by_kind,
                "count_by_kind": coll.count_by_kind,
            },
            "activation_specs": step["activation_specs"],
        }
        print(f"[OK]  {tag}: counted {t_count:.1f}s "
              f"flops={roof.flops:.3e} hbm={roof.hbm_bytes:.3e} "
              f"coll={roof.collective_bytes:.3e} args/dev={argument:.3e} "
              f"dominant={roof.dominant} useful={roof.useful_ratio:.2f} "
              f"anchors={len(step['activation_specs'])}")
    except Exception as e:  # noqa: BLE001 — failures ARE the report
        report = {
            "tag": tag,
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:300]}")
    _save(report, tag, save)
    return report


def _save(report: dict, tag: str, save: bool) -> None:
    if not save:
        return
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, tag + ".json"), "w") as f:
        json.dump(report, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(shapes_mod.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="full 10x4 matrix")
    ap.add_argument("--variant", default="", help="report filename suffix")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shape_names = (list(shapes_mod.SHAPES) if (args.all or not args.shape)
                   else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    t0 = time.time()
    for multi_pod in meshes:
        for arch in archs:
            for shape_name in shape_names:
                report = run_one(arch, shape_name, multi_pod,
                                 variant=args.variant)
                failures += report["status"] == "error"
    print(f"\ndone in {time.time() - t0:.1f}s; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
