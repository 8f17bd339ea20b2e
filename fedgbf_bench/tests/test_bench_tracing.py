"""The reduction of a traced window: busy time as the union of the
device's activity, the device time by name, and each idle gap named by
the innermost span and host operation open at its middle."""

import pytest

from fedgbf_bench import tracing


def test_reduce_events():
    device = [("k1", 10, 20), ("k2", 15, 30), ("k1", 50, 60),
              ("copy", 95, 120)]
    spans = [("job", 0, 100), ("round N", 8, 45), ("round N", 45, 100)]
    ops = [("aten::add", 32, 40), ("aten::sort", 70, 90)]
    r = tracing.reduce_events((0, 100), device, spans, ops)
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx((20 + 10 + 5) * 1e-6)
    assert r.kernel_s == pytest.approx({"k1": 20e-6, "k2": 15e-6,
                                        "copy": 5e-6})
    # gaps [0, 10), [30, 50) and [60, 95), named at 5, 40 and 77.5
    assert r.idle_by_host == pytest.approx({
        "job": 10e-6, "round N / aten::add": 20e-6,
        "round N / aten::sort": 35e-6})
    b = r.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 3


def test_innermost_nested():
    iv = [(0, 100), (10, 50), (20, 30), (60, 70)]
    assert tracing.innermost(iv, [5, 25, 40, 65, 80, 150]) == [
        0, 2, 1, 3, 0, -1]


def test_round_label():
    assert tracing._round_label("round 17") == "round N"
    assert tracing._round_label("binning") == "binning"
