"""Traffic of a batch scoring job: a stream of ``stream_rows`` raw rows made
from the seed, cycled, one ``serve_stream`` call a batch of ``batch`` rows
on a ``ModelSlot`` with a one-rung ``BatchLadder`` (a closed loop: the
next batch goes when the last one's scores are in host memory).

The ensemble is made in set-up from the seed at the configuration's
shapes: the schedule's trees of its depth, thresholds on the data's bin
edges, leaves drawn on the device.  No training code runs.

Facts of a window: its length, the rows and batches scored and each
batch call's wall, timed from the call until its scores are in host
memory.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from fedgbf_bench import counts, data
from fedgbf_bench.reference import draws
from fedgbf_bench.reference import fedgbf as ref

#: the program's traversal kernel (kernels/ensemble_predict/csrc)
TRAVERSE_KERNELS = ("ensemble_predict_kernel",)
#: the keys of a scoring mix; anything else (a quantized table, an open
#: loop) is refused, not run
TRAFFIC = ("kind", "stream_rows", "batch", "impl", "leaf_scale",
           "warm_batches", "check_every", "traced_batches", "why")


class State:
    pass


def _ensemble(env, edges: np.ndarray):
    """(the program's model on the device, the same tables on the host)."""
    import torch

    from repro_torch.core.types import EnsembleModel, TreeArrays

    model, tree = env.config["model"], env.config["tree"]
    trees = draws.trees_per_round(model)
    depth, num_bins = tree["max_depth"], tree["num_bins"]
    d = edges.shape[0]
    total, internal, leaves = sum(trees), 2 ** depth - 1, 2 ** depth
    gen = torch.Generator(device=env.device)
    gen.manual_seed(int(env.seed) % (1 << 63))
    feature = torch.randint(0, d, (total, internal), generator=gen,
                            device=env.device, dtype=torch.int32)
    threshold = torch.randint(0, num_bins - 1, (total, internal),
                              generator=gen, device=env.device,
                              dtype=torch.int32)
    leaf = torch.randn((total, leaves), generator=gen, device=env.device,
                       dtype=torch.float32) * float(env.traffic["leaf_scale"])
    gain = torch.zeros((total, internal), dtype=torch.float32,
                       device=env.device)
    bounds = np.concatenate([[0], np.cumsum(trees)])
    forests = tuple(TreeArrays(feature[a:b], threshold[a:b], gain[a:b],
                               leaf[a:b])
                    for a, b in zip(bounds[:-1], bounds[1:]))
    program = EnsembleModel(
        forests=forests, learning_rate=model["learning_rate"],
        base_score=model["base_score"],
        bin_edges=torch.from_numpy(edges).to(env.device), loss=model["loss"],
        max_depth=depth)
    host = {"feature": feature.cpu().numpy(),
            "threshold": threshold.cpu().numpy(),
            "leaf": leaf.cpu().numpy(), "edges": edges, "trees": trees,
            "lr": model["learning_rate"], "base": model["base_score"],
            "depth": depth}
    return program, host


def setup(env) -> State:
    """The stream and the ensemble from the seed, packed and warmed: the
    ladder's rung, then ``warm_batches`` calls."""
    import torch

    from repro_torch.core.types import pack_ensemble
    from repro_torch.launch import serve_fedgbf as serve

    traffic, config = env.traffic, env.config
    bad = sorted(set(traffic) - set(TRAFFIC))
    if bad:
        raise ValueError(f"the score_stream driver does not run {bad}")
    ref.refuse_unimplemented(config["model"], config["tree"])
    ds = data.make(config["dataset"], env.seed)
    x_train, _ = data.training_rows(ds, config["dataset"]["rows"])
    edges = ref.quantile_edges(torch.from_numpy(x_train).double(),
                               config["tree"]["num_bins"]).float().numpy()
    rng = np.random.default_rng(data.seed_words(env.seed))
    rows, batch = int(traffic["stream_rows"]), int(traffic["batch"])
    if rows % batch:
        raise ValueError(f"stream of {rows} rows is not whole batches of "
                         f"{batch}")
    idx = rng.integers(0, ds.x_test.shape[0], rows)
    s = State()
    s.env = env
    s.stream = np.ascontiguousarray(ds.x_test[idx], np.float32)
    s.batch = batch
    s.check_every = int(traffic["check_every"])
    s.check_offset = int(env.seed) % s.check_every
    program, s.host = _ensemble(env, edges)
    packed = pack_ensemble(program)
    s.metrics = serve.StreamMetrics(batch)
    s.slot = serve.ModelSlot(packed, traffic["impl"], metrics=s.metrics)
    s.ladder = serve.BatchLadder([batch])
    with env.spans.span("warm"):
        s.ladder.warm(packed, s.stream.shape[1], traffic["impl"])
        for i in range(int(traffic["warm_batches"])):
            _call(s, i)
    s.calls = 0
    return s


def _call(s: State, i: int) -> np.ndarray:
    from repro_torch.launch import serve_fedgbf as serve

    pos = (i * s.batch) % s.stream.shape[0]
    out, _ = serve.serve_stream(s.slot, s.stream[pos:pos + s.batch],
                                ladder=s.ladder, metrics=s.metrics)
    return out


def traced_count(traffic: dict) -> int:
    return int(traffic["traced_batches"])


def run(s: State, seconds: float | None = None,
        count: int | None = None) -> dict:
    """Batches back to back until ``seconds`` have passed (the batch in
    progress ends the window) or ``count`` batches are done.  The first
    batch's scores and every ``check_every``-th batch's after it (from an
    offset the seed picks) are kept for the comparison."""
    latencies, kept = [], []
    failed = 0
    i0 = s.calls
    t_start = time.perf_counter()
    t_end = t_start
    while True:
        i = s.calls
        t0 = time.perf_counter()
        try:
            with s.env.spans.span("serve_stream"):
                out = _call(s, i)
            if i == i0 or i % s.check_every == s.check_offset:
                kept.append(((i * s.batch) % s.stream.shape[0], out))
        except Exception:  # a failed batch counts; the window goes on
            failed += 1
            if failed == 1:
                traceback.print_exc(file=sys.stderr)
        t_end = time.perf_counter()
        latencies.append(t_end - t0)
        s.calls += 1
        if seconds is not None and t_end - t_start >= seconds:
            break
        if count is not None and s.calls - i0 >= count:
            break
    batches = len(latencies)
    return {
        "window_s": t_end - t_start, "attempted": batches, "failed": failed,
        "batches": batches, "rows": (batches - failed) * s.batch,
        "latencies_s": latencies, "kept": kept,
        "batch_least_s": counts.batch_least_s(
            s.batch, s.stream.shape[1], len(s.host["leaf"]),
            s.host["depth"]),
        "traverse_kernels": TRAVERSE_KERNELS,
    }


def collect(s: State, facts: dict) -> list:
    return facts.pop("kept")


def release(s: State) -> None:
    s.slot = s.ladder = s.metrics = None


def check(env, s: State, outputs: list) -> dict:
    """Every kept batch's scores against the plain reference's scores of
    the same rows (``reference/fedgbf.py``, float64): the largest gap, and
    the rows that came back missing or not finite."""
    numbers = {"score_gap": 0.0, "unanswered_rows": 0}
    if not outputs:
        return {k: None for k in numbers}
    expected = {}
    for pos in sorted({p for p, _ in outputs}):
        expected[pos] = ref.score(s.stream[pos:pos + s.batch], s.host)
    for pos, out in outputs:
        want = expected[pos]
        out = np.asarray(out, np.float64).reshape(-1)
        if out.shape != want.shape:
            numbers["unanswered_rows"] += s.batch
            continue
        good = np.isfinite(out)
        numbers["unanswered_rows"] += int((~good).sum())
        if good.any():
            numbers["score_gap"] = max(numbers["score_gap"], float(
                np.abs(out[good] - want[good]).max()))
    return numbers


def control(env, s: State) -> dict:
    """The control: the plain reference in bfloat16 put in the program's
    place, on every batch of the stream, judged as the program's scores
    are."""
    import torch

    outputs = [(pos, ref.score(s.stream[pos:pos + s.batch], s.host,
                               dtype=torch.bfloat16))
               for pos in range(0, s.stream.shape[0], s.batch)]
    return check(env, s, outputs)
