"""The port's tracer (``repro_torch/obs/trace.py``): the disabled path
allocates nothing, every live span marks a running profiler's trace as
``span:<name>``, ``use`` installs and restores the process tracer, and the
phase spans of training and serving open where and as often as their
layers' boundaries say (CPU)."""

import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.core import boosting, prng
from repro_torch.core.backend import get_backend
from repro_torch.core.types import TreeConfig, pack_ensemble
from repro_torch.launch import serve_fedgbf as serve
from repro_torch.obs import trace

TREE = TreeConfig(max_depth=3, num_bins=16)
ROUNDS = 2
TREE_PHASES = ("tree.histogram", "tree.split", "tree.route")


def _data(n=400, d=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    return x, y


def _cfg():
    return boosting.dynamic_fedgbf_config(rounds=ROUNDS, tree=TREE)


def _profiled_names(fn) -> Counter:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return Counter(e.name for e in prof.events()
                   if e.name.startswith(trace.SPAN_PREFIX))


def test_null_span_is_shared_without_profiler():
    tr = trace.NULL_TRACER
    assert tr.span("a") is tr.span("b") is trace._NULL_SPAN


def test_null_span_allocates_nothing():
    tr = trace.NULL_TRACER
    with tr.span("warm"):
        pass
    tracemalloc.start()
    before, _ = tracemalloc.get_traced_memory()
    for _ in range(1000):
        with tr.span("hot", cat="tree", args=None):
            pass
    after, _ = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert after - before < 512  # loop-iterator slack only


@pytest.mark.parametrize("kind", ["null", "recording"])
def test_spans_mark_a_running_profiler(kind):
    tr = trace.NullTracer() if kind == "null" else trace.Tracer()

    def work():
        with tr.span("outer"):
            with tr.span("inner", args={"level": 0}):
                torch.ones(3).add_(1)

    names = _profiled_names(work)
    assert names == Counter({"span:outer": 1, "span:inner": 1})
    # the profiler gone, the null path is the shared singleton again
    assert trace.NULL_TRACER.span("x") is trace._NULL_SPAN
    if kind == "recording":
        assert [s.name for s in tr.spans] == ["inner", "outer"]
        assert [s.depth for s in tr.spans] == [1, 0]


def test_recording_span_mark_closes_on_exception():
    tr = trace.Tracer()

    def work():
        with pytest.raises(RuntimeError):
            with tr.span("failing"):
                raise RuntimeError("boom")
        with tr.span("after"):
            pass

    assert _profiled_names(work) == Counter({"span:failing": 1,
                                             "span:after": 1})
    assert [s.name for s in tr.spans] == ["failing", "after"]


def test_use_installs_and_restores():
    outer, inner = trace.Tracer(), trace.Tracer()
    assert trace.global_tracer() is trace.NULL_TRACER
    with trace.use(outer) as got:
        assert got is outer and trace.global_tracer() is outer
        with trace.use(inner):
            assert trace.global_tracer() is inner
        assert trace.global_tracer() is outer
    assert trace.global_tracer() is trace.NULL_TRACER


def test_use_restores_after_an_exception():
    tr = trace.Tracer()
    with pytest.raises(ValueError):
        with trace.use(tr):
            raise ValueError("boom")
    assert trace.global_tracer() is trace.NULL_TRACER


def _train(backend, tracer):
    x, y = _data()
    return boosting.train_fedgbf(x, y, _cfg(), prng.PRNGKey(0),
                                 backend=backend, tracer=tracer,
                                 device="cpu")


def _within(span, outer) -> bool:
    return outer.t0 <= span.t0 and span.t1 <= outer.t1


@pytest.mark.parametrize("backend", ["local", "vfl-histogram"])
def test_train_spans_per_level_inside_rounds(backend):
    bk = (get_backend(backend, tree=TREE, num_parties=2)
          if backend.startswith("vfl") else backend)
    tr = trace.Tracer()
    _train(bk, tr)
    assert trace.global_tracer() is trace.NULL_TRACER
    names = Counter(s.name for s in tr.spans)
    for once in ("job.inputs", "binning", "job.masks", "job.fetch"):
        assert names[once] == 1, once
    rounds = [s for s in tr.spans if s.name.startswith("round ")
              and s.name[6:].isdigit()]
    assert len(rounds) == ROUNDS
    for r in rounds:
        inside = Counter(s.name for s in tr.spans
                         if s is not r and _within(s, r))
        for phase in TREE_PHASES:
            assert inside[phase] == TREE.max_depth, phase
            levels = sorted(s.args["level"] for s in tr.spans
                            if s.name == phase and _within(s, r))
            assert levels == list(range(TREE.max_depth))
        assert inside["tree.leaf"] == 1     # no compaction: leaves only
        assert inside["round.gradients"] == inside["round.update"] == 1
        if backend == "local":
            assert "federation.exchange" not in inside
            assert "kernel.histogram" not in inside
        else:
            # the (g, h) broadcast, then a level's histograms, feature
            # masks and routing maps; one launch a level for both parties
            assert inside["federation.exchange"] == 1 + 3 * TREE.max_depth
            assert inside["kernel.histogram"] == TREE.max_depth


def test_sharded_spans_open_per_level_not_per_block():
    """No span opens per (party, shard) block: the level's one histogram
    launch records its blocks on the ``federation.hist_blocks`` counter."""
    parties, shards = 2, 2
    bk = get_backend("vfl-histogram-sharded", tree=TREE,
                     num_parties=parties, data_shards=shards)
    tr = trace.Tracer()
    _train(bk, tr)
    names = Counter(s.name for s in tr.spans)
    levels = ROUNDS * TREE.max_depth
    assert names["kernel.histogram"] == levels
    assert [values for name, _, values in tr.counters
            if name == "federation.hist_blocks"] == (
        [{"blocks": parties * shards}] * levels)
    assert names["federation.exchange"] == ROUNDS + 3 * levels
    for phase in TREE_PHASES:
        assert names[phase] == levels


def test_train_marks_the_profiler_through_the_null_tracer():
    names = _profiled_names(lambda: _train("local-cuda", None))
    assert names["span:job.masks"] == 1
    assert names["span:round.update"] == ROUNDS
    levels = ROUNDS * TREE.max_depth
    assert names["span:tree.histogram"] == levels
    assert names["span:kernel.histogram"] == levels     # a launch a level


@pytest.fixture(scope="module")
def packed():
    model, _ = _train("local", None)
    return pack_ensemble(model)


def test_serve_spans_a_batch(packed):
    x, _ = _data(n=300, seed=1)
    x[5, 1] = np.inf
    tr = trace.Tracer()
    ladder = serve.BatchLadder([128])
    metrics = serve.StreamMetrics(128)
    with trace.use(tr):
        out, _ = serve.serve_stream(serve.ModelSlot(packed, "packed"), x,
                                    ladder=ladder, metrics=metrics)
    assert np.isnan(out[5]) and np.isfinite(np.delete(out, 5)).all()
    batches = 3                                    # 128 + 128 + 44 rows
    phases = ("serve.admit", "serve.copy_in", "serve.score",
              "serve.copy_out")
    assert [s.name for s in tr.spans] == list(phases) * batches
    assert [s.args["batch"] for s in tr.spans[::4]] == [0, 1, 2]
    assert metrics.latency.count == batches


def test_serve_latency_covers_the_copy_back(packed, monkeypatch):
    """The batch latency runs from admission to the scores in ``out``:
    a slow copy back shows in it."""
    x, _ = _data(n=128, seed=2)
    real_cpu = torch.Tensor.cpu

    def slow_cpu(self, *a, **kw):
        import time
        time.sleep(0.05)
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", slow_cpu)
    metrics = serve.StreamMetrics(128)
    serve.serve_stream(serve.ModelSlot(packed, "packed"), x,
                       ladder=serve.BatchLadder([128]), metrics=metrics)
    assert metrics.latency.count == 1
    assert metrics.latency.quantile(0.5) >= 0.04
