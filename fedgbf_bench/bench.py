"""One run of one cell: set-up, the window (timed, or traced), the memory
peak, the comparison with the plain reference, and the metrics read from
what the window left.  ``run.py`` wraps it with the checks of the
machine; the tests drive it on the CPU."""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass

from fedgbf_bench import spec as spec_mod
from fedgbf_bench import tracing


@dataclass
class Env:
    cell: str
    config: dict
    traffic: dict
    seed: int
    device: object
    spans: tracing.HostSpans


def environment(spec: dict, cell_name: str, seed: int, device,
                config: dict | None = None,
                traffic: dict | None = None) -> Env:
    w = spec_mod.cell(spec, cell_name)
    return Env(cell=cell_name,
               config=config or spec_mod.config_data(spec, w["config"]),
               traffic=traffic or spec_mod.traffic(w["traffic"]),
               seed=int(seed), device=device, spans=tracing.HostSpans())


def _finite(v: float) -> float:
    """A reading for JSON: an infinite gap is printed as the largest
    double."""
    return v if math.isfinite(v) else math.copysign(1.7976931348623157e308, v)


def execute(spec: dict, env: Env, seconds: float, trace: bool,
            t_process: float, limits: dict) -> dict:
    """The run's result: every key of the last line but ``device``'s
    card fields, which ``run.py`` adds."""
    import torch

    cuda = env.device.type == "cuda"
    drv = spec_mod.driver(env.traffic["kind"])
    # Set-up and the window run on one intra-op thread: the load of one
    # process with few threads on a host whose cores are shared.  The
    # reference after the window gets the default back.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with env.spans.span("setup"):
        state = drv.setup(env)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process
    parts = {sp.name: sp.t1 - sp.t0 for sp in env.spans.spans}
    print(f"setup: {setup_s:.3f} s, of which the traffic driver's set-up "
          f"{parts.get('setup', 0.0):.3f} s (warm work "
          f"{parts.get('warm job', parts.get('warm', 0.0)):.3f} s)",
          file=sys.stderr)
    # What set-up left is kept out of the window's garbage collections.
    gc.collect()
    gc.freeze()
    reading = None
    if trace:
        facts, reading = tracing.profile(
            lambda: drv.run(state, count=drv.traced_count(env.traffic)),
            env.spans, cuda)
    else:
        facts = drv.run(state, seconds=seconds)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()
    torch.set_num_threads(threads)
    walls = sorted(facts.get("job_walls_s") or facts.get("latencies_s"))
    if walls:
        print(f"window: {len(walls)} calls in {facts['window_s']:.3f} s; "
              f"a call min {walls[0]:.6f} median {walls[len(walls) // 2]:.6f}"
              f" max {walls[-1]:.6f} s", file=sys.stderr)
    outputs = drv.collect(state, facts)
    drv.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drv.check(env, state, outputs)

    ctx = {"setup_s": setup_s, "facts": facts, "trace": reading,
           "config": env.config, "traffic": env.traffic}
    wanted = (spec_mod.per_layer(spec, env.cell) if trace
              else spec_mod.end_to_end(spec, env.cell))
    metrics = {}
    for m in wanted:
        value = spec_mod.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {}
    correct = facts["failed"] == 0 and facts["attempted"] > 0
    for name, limit in limits.items():
        value = numbers.get(name)
        correct = correct and value is not None and value <= limit
        checks[name] = {"value": None if value is None else _finite(value),
                        "limit": limit}
    result = {"correct": bool(correct), "attempted": facts["attempted"],
              "failed": facts["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": int(memory_peak)}}
    if reading is not None:
        result["device"]["busy_s"] = reading.busy_s
        result["device"]["window_s"] = reading.window_s
        result["breakdown"] = reading.breakdown()
    result["checks"] = checks
    return result
