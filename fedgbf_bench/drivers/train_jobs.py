"""Traffic of whole training jobs: ``train_fedgbf`` called back to back on
one dataset, as the port's training launcher calls it (``eval_every`` from
the mix, no ``masks=``: every job draws its masks from the run's key
inside the call).  The backend is ``local-cuda`` or the vertically
federated ``vfl`` one over ``parties`` column blocks and ``data_shards``
row shards, metered.

Facts of a window: its length, the jobs and rounds it completed, the wire
bytes the jobs metered, each job's ``overhead_s``, the histogram launches,
and the shape of a job for the least-time counts.

The program splits the columns among the parties in even blocks only, so
where they do not divide, constant zero columns are padded on the right
(they never split).  The wire bytes and the least-time counts take the
data's own columns alone: a padded column's histograms and feature mask
are left out of them.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from fedgbf_bench import counts, data
from fedgbf_bench.reference import draws
from fedgbf_bench.reference import fedgbf as ref

#: the histogram kernels' entry points, whose launches the program counts
HIST_ENTRIES = ("histogram_round", "histogram_tree", "histogram_staged")
#: the kernels of the program's histogram source (kernels/histogram/csrc)
HIST_KERNELS = ("slot_count_kernel", "slot_scan_kernel",
                "slot_scatter_kernel", "walk_kernel")
#: the keys of a training mix, each with the values this driver runs
#: (None: any); anything else is refused, not run
TRAFFIC = {"kind": ("train_jobs",), "backend": ("local-cuda", "vfl"),
           "parties": None, "data_shards": None,
           "aggregation": ("histogram", "argmax"), "eval_every": None,
           "traced_jobs": None, "why": None}
#: metered per-passive phases whose payload is a party's columns
COLUMN_PHASES = ("histograms", "feature_mask")


def refuse_unimplemented(traffic: dict, config: dict) -> None:
    """Raise ``ValueError`` for a traffic key or value this driver does
    not run, or a configuration the plain reference does not implement."""
    bad = [f"{k}={v!r}" for k, v in traffic.items()
           if k not in TRAFFIC or (TRAFFIC[k] is not None
                                   and v not in TRAFFIC[k])]
    if bad:
        raise ValueError("the train_jobs driver does not run "
                         + ", ".join(bad))
    ref.refuse_unimplemented(config["model"], config["tree"])


def fedgbf_config(config: dict):
    from repro_torch.core.types import FedGBFConfig, TreeConfig

    m = config["model"]
    keys = ("rounds", "learning_rate", "loss", "sampling", "base_score",
            "n_trees_max", "n_trees_min", "n_trees_speed", "rho_id_min",
            "rho_id_max", "rho_id_speed", "rho_feat")
    return FedGBFConfig(tree=TreeConfig(**config["tree"]),
                        **{k: m[k] for k in keys})


def job_shape(x: np.ndarray, config: dict) -> counts.JobShape:
    """The shape of a job on the data ``x``, before any padding."""
    n, d = x.shape
    model, tree = config["model"], config["tree"]
    return counts.JobShape(
        n=n, d=d, trees=tuple(draws.trees_per_round(model)),
        keep=tuple(draws.keep_count(n, r) for r in draws.rho_per_round(model)),
        depth=tree["max_depth"], num_bins=tree["num_bins"],
        subtraction=bool(tree["hist_subtraction"]))


class State:
    pass


def setup(env) -> State:
    """Data from the seed, the backend, and one whole job to build and
    warm every kernel and shape the window uses."""
    from repro_torch.federation import compress, vfl

    traffic, config = env.traffic, env.config
    refuse_unimplemented(traffic, config)
    ds = data.make(config["dataset"], env.seed)
    x, y = data.training_rows(ds, config["dataset"]["rows"])
    s = State()
    s.env = env
    s.cfg = fedgbf_config(config)
    s.meter = None
    s.parties = 1
    s.shape = job_shape(x, config)
    if traffic["backend"] == "vfl":
        s.parties = int(traffic["parties"])
        x = data.pad_columns(x, s.parties)
        s.meter = compress.MessageMeter()
        shards = int(traffic["data_shards"])
        s.backend = vfl.make_vfl_backend(
            s.parties, s.cfg.tree, aggregation=traffic["aggregation"],
            meter=s.meter, shard_samples=shards > 1, data_shards=shards)
    elif traffic["backend"] == "local-cuda":
        s.backend = "local-cuda"
    else:
        raise ValueError(f"unknown backend {traffic['backend']!r}")
    s.x = np.ascontiguousarray(x, np.float32)
    s.y = np.ascontiguousarray(y, np.float32)
    with env.spans.span("warm job"):
        _job(s)
    return s


def _job(s: State):
    from repro_torch.core import boosting, prng

    if s.meter is not None:
        s.meter.reset()
    return boosting.train_fedgbf(
        s.x, s.y, s.cfg, prng.PRNGKey(s.env.seed), backend=s.backend,
        eval_every=int(s.env.traffic["eval_every"]), tracer=s.env.spans,
        device=s.env.device)


def _wire_bytes(s: State) -> float:
    """A job's bytes on the wire: a per-passive phase times the passive
    parties (the meter records one party's payload), a phase of a party's
    columns times the passive parties' data columns over a party's
    columns."""
    from repro_torch.federation import protocol

    passive = s.parties - 1
    d_party = s.x.shape[1] // s.parties
    passive_columns = s.shape.d - min(d_party, s.shape.d)
    total = 0.0
    for phase, b in s.meter.phase_totals().items():
        if phase in COLUMN_PHASES:
            total += b * passive_columns / d_party
        elif phase in protocol.PER_PASSIVE_PHASES:
            total += b * passive
        else:
            total += b
    return total


def _launches() -> int:
    from repro_torch.kernels.histogram import ops

    return sum(ops.kernel_launches(k) for k in HIST_ENTRIES)


def traced_count(traffic: dict) -> int:
    return int(traffic["traced_jobs"])


def run(s: State, seconds: float | None = None,
        count: int | None = None) -> dict:
    """Whole jobs back to back until ``seconds`` have passed (the job in
    progress then ends the window) or ``count`` jobs are done."""
    jobs, walls, overheads, wires = [], [], [], []
    failed = 0
    launches0 = _launches()
    t_start = time.perf_counter()
    t_end = t_start
    while True:
        t0 = time.perf_counter()
        try:
            with s.env.spans.span("job"):
                model, hist = _job(s)
            jobs.append((model, hist.final_margin))
            overheads.append(hist.overhead_s)
            if s.meter is not None:
                wires.append(_wire_bytes(s))
        except Exception:  # a failed job counts; the window goes on
            failed += 1
            if failed == 1:
                traceback.print_exc(file=sys.stderr)
        t_end = time.perf_counter()
        walls.append(t_end - t0)
        if seconds is not None and t_end - t_start >= seconds:
            break
        if count is not None and len(walls) >= count:
            break
    attempted = len(walls)
    return {
        "window_s": t_end - t_start, "attempted": attempted,
        "failed": failed, "jobs": jobs, "job_walls_s": walls,
        "rounds": len(jobs) * s.cfg.rounds,
        "rounds_per_job": s.cfg.rounds,
        "overhead_s": overheads,
        "wire_bytes": sum(wires) if s.meter is not None else None,
        "hist_launches": _launches() - launches0,
        "job_shape": s.shape,
        "hist_kernels": HIST_KERNELS,
    }


def collect(s: State, facts: dict) -> list:
    """Each job's outputs on the host: edges, node tables, leaves and the
    final margins."""
    from repro_torch.core.types import pack_ensemble

    out = []
    for model, margin in facts.pop("jobs"):
        p = pack_ensemble(model)
        out.append({"edges": p.bin_edges.cpu().numpy(),
                    "feature": p.feature.cpu().numpy(),
                    "threshold": p.threshold.cpu().numpy(),
                    "leaf": p.leaf_weight.cpu().numpy(),
                    "margin": np.asarray(margin),
                    "round_offsets": p.round_offsets})
    return out


def release(s: State) -> None:
    s.backend = s.meter = None


def malformed(job: dict, shape: counts.JobShape, columns: int) -> bool:
    """A job whose outputs do not have the scheduled shapes (on the
    ``columns`` handed in, padding included) or hold a non-finite
    number."""
    builds = sum(shape.trees)
    internal, leaves = 2 ** shape.depth - 1, 2 ** shape.depth
    offsets = tuple(int(v) for v in np.concatenate([[0], np.cumsum(
        shape.trees)]))
    ok = (job["edges"].shape == (columns, shape.num_bins - 1)
          and job["feature"].shape == (builds, internal)
          and job["threshold"].shape == (builds, internal)
          and job["leaf"].shape == (builds, leaves)
          and job["margin"].shape == (shape.n,)
          and tuple(job["round_offsets"]) == offsets
          and all(np.isfinite(job[k]).all()
                  for k in ("edges", "leaf", "margin")))
    return not ok


def check(env, s: State, outputs: list) -> dict:
    """The readings of every job the window produced: each distinct
    output judged once by the plain reference (``reference/fedgbf.py``),
    on the same inputs, followed by the number of malformed jobs."""
    numbers = {"edge_gap": 0.0, "split_gap": 0.0, "leaf_gap": 0.0,
               "margin_gap": 0.0, "malformed_jobs": 0}
    judged: list = []
    for job in outputs:
        if malformed(job, s.shape, s.x.shape[1]):
            numbers["malformed_jobs"] += 1
            continue
        if any(_same(job, seen) for seen, _ in judged):
            continue
        r = ref.judge(s.x, s.y, env.config["model"], env.config["tree"],
                      env.seed, job)
        judged.append((job, r))
        for k, v in r.items():
            numbers[k] = max(numbers[k], v)
    if not outputs:
        numbers = {k: None for k in numbers}
    return numbers


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in
               ("edges", "feature", "threshold", "leaf", "margin"))


def control(env, s: State) -> dict:
    """The control: the plain reference in bfloat16 put in the program's
    place, judged as a job is."""
    import torch

    job = ref.grow(s.x, s.y, env.config["model"], env.config["tree"],
                   env.seed, dtype=torch.bfloat16)
    return ref.judge(s.x, s.y, env.config["model"], env.config["tree"],
                     env.seed, job)
