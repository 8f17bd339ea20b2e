"""Faults planted in the program underneath a run, to show that the
comparison refuses them: each is a context manager that breaks one step of
the timed path and restores it on exit.  ``calibrate.py`` reads them at a
cell's own size; ``tests/test_bench_faults.py`` drives whole runs through
them on the CPU.

Training (the kinds of fault a training cell can have):
* ``state_unchanged``: the boosting step returns the margins unchanged;
* ``half_batch``: the trees see half the rows (the second half's sample
  weights zeroed), their statistics taken over the rest;
* ``exchange_dropped``: the exchange is left out: no passive party's
  histograms arrive (zeros), for the federated backends;
* ``answer_altered``: one leaf weight of every round's first tree is moved.

Scoring:
* ``half_batch``: half of every batch is never scored (margin 0);
* ``answer_altered``: one row's margin of every batch is moved.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def train_state_unchanged():
    from repro_torch.core import boosting

    return _patched(boosting, "_boost",
                    lambda orig: lambda margin, per_tree, lr: margin)


def train_half_batch():
    from repro_torch.core import forest

    def make(orig):
        def broken(binned, g, h, sample_mask, *args, **kw):
            w = sample_mask.clone()
            w[:, sample_mask.shape[1] // 2:] = 0
            return orig(binned, g, h, w, *args, **kw)
        return broken

    return _patched(forest, "build_forest_per_tree", make)


def train_exchange_dropped():
    from repro_torch.federation import aggregator

    def make(orig):
        def broken(*args, **kw):
            local = orig(*args, **kw)
            return local[:1] + [part * 0 for part in local[1:]]
        return broken

    return _patched(aggregator, "_local_histograms", make)


def train_answer_altered():
    from repro_torch.core import split

    def make(orig):
        def broken(hist_leaf, cfg):
            w = orig(hist_leaf, cfg).clone()
            w[0, 0] += 0.05
            return w
        return broken

    return _patched(split, "leaf_weights", make)


def serve_half_batch():
    from repro_torch.core import boosting

    def make(orig):
        def broken(model, x, impl="packed"):
            out = orig(model, x, impl=impl).clone()
            out[out.shape[0] // 2:] = 0
            return out
        return broken

    return _patched(boosting, "predict", make)


def serve_answer_altered():
    from repro_torch.core import boosting

    def make(orig):
        def broken(model, x, impl="packed"):
            out = orig(model, x, impl=impl).clone()
            out[0] += 0.05
            return out
        return broken

    return _patched(boosting, "predict", make)


#: driver kind -> fault name -> context manager factory
FAULTS = {
    "train_jobs": {
        "state_unchanged": train_state_unchanged,
        "half_batch": train_half_batch,
        "exchange_dropped": train_exchange_dropped,
        "answer_altered": train_answer_altered,
    },
    "score_stream": {
        "half_batch": serve_half_batch,
        "answer_altered": serve_answer_altered,
    },
}


def applicable(traffic: dict) -> dict:
    """The faults a cell with this traffic can have: no exchange to drop
    without parties."""
    out = dict(FAULTS[traffic["kind"]])
    if traffic.get("backend") != "vfl":
        out.pop("exchange_dropped", None)
    return out
