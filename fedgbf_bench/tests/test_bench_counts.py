"""The least-time counts: one small shape worked out by hand, and the same
count whatever the parties and row shards."""

import copy

import pytest
import torch

from fedgbf_bench import bench, counts, spec
from fedgbf_bench.drivers import train_jobs


def test_histogram_level_by_hand():
    shape = counts.JobShape(n=100, d=4, trees=(2,), keep=(10,), depth=2,
                            num_bins=8, subtraction=True)
    # level 0: every row at the root, no assignment read; histograms
    # 2 trees * 1 node * 4 columns * 8 bins * 3 * 4 B written
    assert counts.histogram_level(shape, 2, 10, 0) == (
        3.0 * 2 * 10 * 4, 768.0)
    # level 1 under subtraction: each tree's assignment 100 * 4 B read,
    # one left child a parent, no adds counted
    assert counts.histogram_level(shape, 2, 10, 1) == (0.0, 800.0 + 768)
    direct = shape._replace(subtraction=False)
    assert counts.histogram_level(direct, 2, 10, 1) == (
        3.0 * 2 * 10 * 4, 800.0 + 2 * 768)
    # a round adds g and h (2 * 100 * 4) and the trees' weights
    # (2 * 100 * 4); a job the bins (100 * 4 * 4) once
    assert counts.histogram_round(shape, 0) == (240.0, 1600.0 + 768 + 1568)
    assert counts.histogram_job(shape) == (240.0, 1600.0 + 3936)
    assert counts.histogram_job_least_s(shape) == pytest.approx(
        5536 / counts.HBM_BYTES_PER_S)
    # the bins are read once a job, whatever the rounds
    two = shape._replace(trees=(2, 2), keep=(10, 10))
    assert counts.histogram_job(two)[1] == 1600.0 + 2 * 3936


def test_batch_by_hand():
    # 8192 rows x 23 float32 in, 78 trees of 7 (int32 + float32) nodes,
    # 8 leaves and a scale, 8192 scores out
    assert counts.batch_bytes(8192, 23, 78, 3) == (
        8192 * 23 * 4 + 78 * (7 * 8 + 8 * 4 + 4) + 8192 * 4)
    assert counts.batch_least_s(8192, 23, 78, 3) == pytest.approx(
        793_608 / 3.35e12)


def _credit_env(parties, shards, n=1024):
    s = spec.load()
    config = copy.deepcopy(spec.config_data(s, "dynfedgbf-credit"))
    config["dataset"]["n"] = n
    config["model"]["rounds"] = 1
    traffic = {"kind": "train_jobs", "eval_every": 1, "traced_jobs": 1}
    if parties == 1:
        traffic["backend"] = "local-cuda"
    else:
        traffic.update(backend="vfl", parties=parties, data_shards=shards,
                       aggregation="histogram")
    return bench.environment(s, "credit.train.vfl4", 3, torch.device("cpu"),
                             config, traffic)


@pytest.mark.parametrize("parties, shards", [(1, 1), (4, 1), (16, 1),
                                             (16, 16), (4, 16)])
def test_counts_ignore_the_layout(parties, shards):
    """The same data (Default of Credit Card Clients' 23 columns, which 4
    and 16 parties take padded to 24 and 32) under every layout: the
    driver's job shape counts the 23 columns, and every count made from
    it is the same."""
    state = train_jobs.setup(_credit_env(parties, shards))
    expected = counts.JobShape(n=1024 * 7 // 10, d=23, trees=(5,),
                               keep=(215,), depth=3, num_bins=32,
                               subtraction=True)
    assert state.shape == expected
    assert counts.histogram_job(state.shape) == \
        counts.histogram_job(expected)
    assert counts.job_least_s(state.shape) == counts.job_least_s(expected)


def test_column_phases_scale_with_a_partys_columns():
    """What the wire count's rule for padded columns rests on: the metered
    histograms and feature masks of a party are its columns' (4 parties of
    6 columns meter twice what 8 parties of 3 do), and the count takes the
    23 data columns' share of them."""
    totals, wires = {}, {}
    for parties in (4, 8):
        state = train_jobs.setup(_credit_env(parties, 1, n=512))
        assert state.x.shape[1] == 24
        totals[parties] = state.meter.phase_totals()
        wires[parties] = train_jobs._wire_bytes(state)
    for phase in train_jobs.COLUMN_PHASES:
        assert totals[4][phase] == 2 * totals[8][phase] > 0
    per_column = sum(totals[8][k] for k in train_jobs.COLUMN_PHASES) / 3
    # 4 parties: 17 passive data columns; 8 parties: 20
    others = {p: wires[p] - per_column * (23 - 24 // p) for p in (4, 8)}
    grad = totals[4]["grad_broadcast"]
    assert others[4] == pytest.approx(3 * grad + totals[4].get(
        "id_partition", 0))
    assert others[8] == pytest.approx(7 * grad + totals[8].get(
        "id_partition", 0))
