"""The readers of the device's idle time by program phase
(``idle_by_span.py`` and ``metrics/idle_*``) on traced windows reduced by
``tracing.reduce_events``, with nested program spans: each phase's idle a
round or a batch, the unattributed share, and nothing where there is no
trace, no device event, or no phase span (a program that does not
report its phases)."""

import pytest

from fedgbf_bench import idle_by_span, spec, tracing

SPEC = spec.load()


def _device(gaps, lo, hi):
    """The device's busy intervals: the complement of ``gaps`` in
    ``[lo, hi]``."""
    busy, t = [], lo
    for a, b in gaps:
        if a > t:
            busy.append(("kernel", t, a))
        t = b
    if t < hi:
        busy.append(("kernel", t, hi))
    return busy


# two rounds of a job (microseconds); each gap is named by the innermost
# span at its middle
TRAIN_SPANS = [
    ("job", 0, 1000), ("round N", 100, 500), ("round N", 500, 900),
    ("round.gradients", 110, 150), ("tree.histogram", 150, 250),
    ("kernel.histogram", 200, 240), ("tree.split", 260, 300),
    ("tree.route", 300, 350), ("federation.exchange", 330, 350),
    ("tree.leaf", 350, 400), ("round.update", 400, 500),
    ("round.update", 800, 900)]
TRAIN_GAPS = [(100, 140), (160, 190), (210, 230), (265, 295), (305, 325),
              (335, 345), (360, 390), (420, 480), (500, 700), (820, 880),
              (950, 1000)]
TRAIN_OPS = [("aten::add", 440, 460)]
# two batches, the harness's ``serve_stream`` span around each
SERVE_SPANS = [
    ("serve_stream", 0, 180), ("serve.admit", 5, 60),
    ("serve.copy_in", 60, 80), ("serve.score", 80, 150),
    ("serve.copy_out", 150, 175), ("serve_stream", 200, 380),
    ("serve.admit", 205, 260), ("serve.copy_in", 260, 280),
    ("serve.score", 280, 350), ("serve.copy_out", 350, 375)]
SERVE_GAPS = [(10, 50), (62, 78), (100, 140), (155, 170), (176, 179),
              (185, 195), (210, 250), (262, 278), (300, 340), (355, 370),
              (385, 400)]

TRAIN = {  # metric: value from the gaps above, per round of 2
    "idle_hist_ms.train": 30e-3 / 2,
    "idle_hist_launch_ms.train": 20e-3 / 2,
    "idle_split_ms.train": 30e-3 / 2,
    "idle_route_ms.train": 20e-3 / 2,
    "idle_leaf_ms.train": 30e-3 / 2,
    "idle_boost_ms.train": (40 + 60 + 60) * 1e-3 / 2,
    "idle_exchange_ms.train": 10e-3 / 2,
    "idle_unattributed.train": 100.0 * (200 + 50) / 550,
}
SERVE = {  # metric: value per batch of 2
    "idle_admit_us.serve": 40.0,
    "idle_copy_in_us.serve": 16.0,
    "idle_score_us.serve": 40.0,
    "idle_copy_out_us.serve": 15.0,
    "idle_unattributed.serve": 100.0 * (3 + 10 + 15) / 250,
}


def _ctx(spans, gaps, hi, facts, ops=()):
    reading = tracing.reduce_events((0, hi), _device(gaps, 0, hi), spans,
                                    list(ops))
    return {"trace": reading, "facts": facts}


def _train_ctx():
    return _ctx(TRAIN_SPANS, TRAIN_GAPS, 1000, {"rounds": 2}, TRAIN_OPS)


def _serve_ctx():
    return _ctx(SERVE_SPANS, SERVE_GAPS, 400, {"batches": 2})


def test_fixture_labels():
    idle = _train_ctx()["trace"].idle_by_host
    assert idle["round.update / aten::add"] == pytest.approx(60e-6)
    assert idle["round N"] == pytest.approx(200e-6)
    assert idle_by_span.by_span(_train_ctx()["trace"])[
        "round.update"] == pytest.approx(120e-6)


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(SERVE))
def test_reader(name):
    ctx = _train_ctx() if name in TRAIN else _serve_ctx()
    want = TRAIN.get(name, SERVE.get(name))
    assert spec.reader(name)(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(SERVE))
def test_reader_finds_nothing(name):
    read = spec.reader(name)
    unit = "rounds" if name in TRAIN else "batches"
    assert read({"trace": None, "facts": {unit: 2}}) is None
    # no device event
    empty = tracing.reduce_events((0, 100), [], [("round N", 0, 100)], [])
    assert read({"trace": empty, "facts": {unit: 2}}) is None
    # a program without phase spans: idle under the round alone
    parent = _ctx([("job", 0, 1000), ("round N", 100, 900),
                   ("binning", 20, 90)], TRAIN_GAPS, 1000, {unit: 2})
    assert read(parent) is None


def test_every_new_reader_is_declared():
    declared = {m["name"]: m for m in SPEC["per_layer"]}
    for name in list(TRAIN) + list(SERVE):
        m = declared[name]
        assert m["source"] == "program_span"
        assert m["moves"] == ("train_round_ms" if name in TRAIN
                              else "serve_rows_per_s")
