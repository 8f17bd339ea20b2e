"""The plain reference (``fedgbf_bench/reference``) against the port on the
CPU at small sizes: the same masks bit for bit, edges within an ulp, and the
port's jobs and scores within the tolerances of the port's own tests."""

import copy

import numpy as np
import pytest
import torch

from fedgbf_bench import bench, data, spec
from fedgbf_bench.drivers import train_jobs
from fedgbf_bench.reference import draws
from fedgbf_bench.reference import fedgbf as ref

SPEC = spec.load()
CREDIT = spec.config_data(SPEC, "dynfedgbf-credit")
GRID = spec.config_data(SPEC, "fedgbf-gmsc-p10x16")


@pytest.mark.parametrize("config", [CREDIT, GRID], ids=["credit", "grid"])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_masks_equal_the_port(config, seed):
    from repro_torch.core import forest, prng

    cfg = train_jobs.fedgbf_config(config)
    n, d = 1500, 16
    sample, feature = draws.step_masks(config["model"], n, d, seed)
    want = forest.draw_step_masks(cfg, n, d, prng.PRNGKey(seed))
    assert np.array_equal(sample, want.sample.numpy().astype(bool))
    assert np.array_equal(feature, want.feature.numpy())


def test_schedule_equals_the_port():
    from repro_torch.core import dynamic

    for config in (CREDIT, GRID):
        cfg = train_jobs.fedgbf_config(config)
        sched = dynamic.schedule_arrays(cfg)
        assert draws.trees_per_round(config["model"]) == list(sched.n_trees)
        assert draws.rho_per_round(config["model"]) == [
            dynamic.rho_id_schedule(cfg, m) for m in range(1, cfg.rounds + 1)]


@pytest.mark.parametrize("seed", [3, 13])
def test_edges_and_bins_against_the_port(seed):
    """The reference's own edges lie within an ulp of the port's, in ulps
    of their order statistics; the rows binned on the edges the reference
    snaps to are the port's bins."""
    from repro_torch.core import binning

    x = torch.from_numpy(data.default_credit_card(seed, n=30000).x_train)
    mine, ulp = ref.quantile_edges(x.double(), 32, with_ulp=True)
    mine = mine.float()
    port = binning.quantile_bin_edges(x, 32)
    ulps = (port.double() - mine.double()).abs() / ulp
    assert float(ulps.max()) <= 1.0 and bool((port != mine).any())
    snapped = torch.where(ulps <= ref.SNAP_ULPS, port, mine)
    assert torch.equal(ref.bin_data(x, snapped).int(),
                       binning.bin_data(x, port))


def test_unimplemented_configurations_are_refused():
    """A field or value the reference does not implement is refused, not
    judged: GOSS sampling, another loss, compaction, a shared root, an
    unknown key; and the drivers refuse a mix they do not run."""
    from fedgbf_bench.drivers import score_stream

    cases = [({"sampling": "goss"}, {}), ({"loss": "squared"}, {}),
             ({}, {"max_active_nodes": 4}), ({}, {"shared_root": True}),
             ({"goss_top_share": 0.2}, {})]
    for model, tree in cases:
        with pytest.raises(ValueError, match="does not implement"):
            ref.refuse_unimplemented({**CREDIT["model"], **model},
                                     {**CREDIT["tree"], **tree})
    with pytest.raises(ValueError, match="goss"):
        draws.step_masks({**CREDIT["model"], "sampling": "goss"}, 10, 3, 0)
    with pytest.raises(ValueError, match="chaos"):
        train_jobs.refuse_unimplemented(
            {**spec.traffic("train.vfl4"), "chaos": {"drop": 0.05}}, CREDIT)
    with pytest.raises(ValueError, match="backend='local'"):
        train_jobs.refuse_unimplemented(
            {**spec.traffic("train.local"), "backend": "local"}, CREDIT)
    env = bench.environment(SPEC, "credit.serve.b8192", 1,
                            torch.device("cpu"), CREDIT,
                            {**spec.traffic("serve.b8192"), "quantize": 8})
    with pytest.raises(ValueError, match="quantize"):
        score_stream.setup(env)


def _port_job(x, y, config, seed, backend):
    from repro_torch.core import boosting, prng
    from repro_torch.core.types import pack_ensemble

    model, hist = boosting.train_fedgbf(
        x, y, train_jobs.fedgbf_config(config), prng.PRNGKey(seed),
        backend=backend, device="cpu")
    p = pack_ensemble(model)
    return {"edges": p.bin_edges.numpy(), "feature": p.feature.numpy(),
            "threshold": p.threshold.numpy(), "leaf": p.leaf_weight.numpy(),
            "margin": hist.final_margin}


@pytest.mark.parametrize("parties", [1, 4])
def test_judge_reads_the_port_as_sound(parties):
    """A port job on the CPU reads within the cell's limits; the trees of
    the 4-party federation are judged against the centralized reference
    on the same padded columns."""
    from repro_torch.federation import vfl

    ds = data.default_credit_card(11, n=5000)
    x, y = ds.x_train, ds.y_train
    config = copy.deepcopy(CREDIT)
    config["model"]["rounds"] = 8
    backend = "local"
    if parties > 1:
        x = data.pad_columns(x, parties)
        backend = vfl.make_vfl_backend(
            parties, train_jobs.fedgbf_config(config).tree)
    job = _port_job(x, y, config, 11, backend)
    readings = ref.judge(x, y, config["model"], config["tree"], 11, job)
    limits = spec.limits("credit.train.local")
    for k, v in readings.items():
        assert v <= limits[k], (k, v)
    # rounding, not luck: the leaves agree to float32 sums
    assert readings["leaf_gap"] < 1e-4 and readings["margin_gap"] < 1e-5


def test_scores_equal_the_port_within_rounding():
    from repro_torch.core import boosting
    from repro_torch.core.types import EnsembleModel, TreeArrays, pack_ensemble

    rng = np.random.default_rng(5)
    x = data.default_credit_card(5, n=3000).x_test
    edges = ref.quantile_edges(torch.from_numpy(x).double(), 32).float()
    trees = draws.trees_per_round(CREDIT["model"])
    s = sum(trees)
    feature = rng.integers(0, x.shape[1], (s, 7)).astype(np.int32)
    threshold = rng.integers(0, 31, (s, 7)).astype(np.int32)
    feature[rng.random((s, 7)) < 0.1] = -1
    leaf = (rng.normal(size=(s, 8)) * 0.5).astype(np.float32)
    bounds = np.concatenate([[0], np.cumsum(trees)])
    forests = tuple(TreeArrays(torch.from_numpy(feature[a:b]),
                               torch.from_numpy(threshold[a:b]),
                               torch.zeros((b - a, 7)),
                               torch.from_numpy(leaf[a:b]))
                    for a, b in zip(bounds[:-1], bounds[1:]))
    packed = pack_ensemble(EnsembleModel(forests, 0.1, 0.0, edges,
                                         "logistic", 3))
    port = boosting.predict_proba(packed, torch.from_numpy(x), impl="fused")
    mine = ref.score(x, {"feature": feature, "threshold": threshold,
                         "leaf": leaf, "edges": edges.numpy(),
                         "trees": trees, "lr": 0.1, "base": 0.0,
                         "depth": 3})
    assert np.abs(port.double().numpy() - mine).max() < 1e-6
