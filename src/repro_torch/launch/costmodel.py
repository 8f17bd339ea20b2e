"""Costing of the dry-run's programs: the counterpart of
``repro/launch/costmodel.py``.

XLA's ``cost_analysis`` counts a while-loop body once, so the JAX package
costs its rolled production program compositionally (program plus
``(U - 1)`` unit bodies, and the encoder and shared-block terms).  The
port's unit loop is a Python loop and ``tools.roofline.CostCounter`` sees
every op it runs, so the count of the whole step is already the total: the
port needs no composition.

``count_step`` runs the step once on ``meta`` tensors under the counter,
inside ``models.partition.recording`` for the mesh's axes, so every
activation anchor of the forward (and of the remat recompute in training)
records the spec it builds for this mesh.

Per-device numbers assume perfect sharding: FLOPs, bytes and the peak are
the whole count over ``chips``; collective bytes are per device by
``roofline.collective_stats``'s rule; argument bytes are exact from the
partition specs.
"""

from __future__ import annotations

from repro_torch.models import partition
from repro_torch.tools import roofline as roofline_mod


def num_shared_apps(cfg) -> int:
    """Applications of zamba2's shared block: after every unit u with
    ``(u + 1) % shared_attn_every == 0``."""
    if cfg.shared_attn_every <= 0:
        return 0
    return cfg.num_units // cfg.shared_attn_every


def count_step(cfg, spec, mesh) -> dict:
    """Per-device costs of ``cfg``'s whole step at ``spec`` on ``mesh``:
    ``flops``, ``bytes``, ``peak`` (the counter's, over ``chips``),
    ``collective_bytes`` and ``collectives`` (the rule's),
    ``argument_bytes`` (the specs'), ``ops``, and ``activation_specs``
    (``partition.Recorder.summary``: each distinct anchored activation
    spec with the times the step placed it)."""
    from repro_torch.launch import dryrun

    step = dryrun.build_step(cfg, spec, mesh)
    with partition.recording(mesh.shape) as rec, \
            roofline_mod.CostCounter() as counter:
        step.run()
    chips = mesh.size
    coll = step.collectives()
    counted = counter.costs()
    return {"flops": counted["flops"] / chips,
            "bytes": counted["bytes"] / chips,
            "peak": counted["peak"] // chips, "ops": counted["ops"],
            "collective_bytes": float(coll.total_bytes),
            "collectives": coll, "argument_bytes": step.argument_bytes(),
            "activation_specs": rec.summary()}
