"""Port vs JAX package: explainability, the analytic runtime model and the
vertical-partition helpers, on the committed reference checkpoint and
seeded inputs (CPU)."""

from pathlib import Path

import numpy as np
import pytest

from repro.checkpoint import io as j_io
from repro.core import explain as j_explain
from repro.core import runtime_model as j_runtime
from repro.core.types import unpack_ensemble as j_unpack
from repro.data import tabular as j_tabular
from repro_torch.checkpoint import io as t_io
from repro_torch.core import boosting as t_boosting
from repro_torch.core import explain as t_explain
from repro_torch.core import runtime_model as t_runtime
from repro_torch.core.types import unpack_ensemble as t_unpack
from repro_torch.data import tabular as t_tabular
from test_torch_reference import CKPT
from torch_parity import jax_config

CSV = Path(__file__).resolve().parents[1] / "data" / "credit_sample.csv"


@pytest.fixture(scope="module")
def models():
    """(port packed, port per-round, JAX packed, JAX per-round)."""
    tp, jp = t_io.load_ensemble(str(CKPT), device="cpu"), \
        j_io.load_ensemble(str(CKPT))
    return tp, t_unpack(tp), jp, j_unpack(jp)


@pytest.mark.parametrize("kind", ["gain", "count"])
def test_feature_importance_equals_jax(kind, models):
    """Both layouts, both kinds: the JAX numbers exactly."""
    tp, tm, jp, jm = models
    d = tp.bin_edges.shape[0]
    for t_model, j_model in ((tp, jp), (tm, jm)):
        got = t_explain.feature_importance(t_model, d, kind)
        np.testing.assert_array_equal(
            got, j_explain.feature_importance(j_model, d, kind))
    assert abs(got.sum() - 1.0) < 1e-12


def test_party_importance_and_dump_tree_equal_jax(models):
    tp, tm, jp, jm = models
    for dims in ((12, 11), (5, 6, 12)):
        t_part = t_tabular.partition_from_dims(dims)
        j_part = j_tabular.partition_from_dims(dims)
        for kind in ("gain", "count"):
            assert t_explain.party_importance(tp, t_part, kind) == \
                j_explain.party_importance(jp, j_part, kind)
    names = [f"col{i}" for i in range(23)]
    for r, t in ((0, 0), (7, 1), (19, 1)):
        assert t_explain.dump_tree(tm, r, t) == j_explain.dump_tree(jm, r, t)
        assert t_explain.dump_tree(tm, r, t, names) == \
            j_explain.dump_tree(jm, r, t, names)


def test_runtime_model_equals_jax():
    for cfg in (t_boosting.dynamic_fedgbf_config(rounds=20),
                t_boosting.secureboost_config(rounds=13),
                t_boosting.federated_forest_config(n_trees=7)):
        j_cfg = jax_config(cfg)
        assert t_runtime.round_schedules(cfg) == \
            j_runtime.round_schedules(j_cfg)
        got = t_runtime.estimate_fedgbf_runtime(cfg, 2.0, 5.0)
        want = j_runtime.estimate_fedgbf_runtime(j_cfg, 2.0, 5.0)
        assert (got.as_interval(), got.t0_s) == (want.as_interval(),
                                                 want.t0_s)
    assert t_runtime.estimate_secureboost_runtime(13, 2.0, 5.0, 0.5, 0.8) \
        == j_runtime.estimate_secureboost_runtime(13, 2.0, 5.0, 0.5, 0.8)
    assert t_runtime.error_rate(9.0, 10.0) == j_runtime.error_rate(9.0, 10.0)
    for alpha, n in ((0.1, 1000), (0.5, 21000), (1.0, 2)):
        assert t_runtime.subsample_time_ratio(alpha, n) == \
            j_runtime.subsample_time_ratio(alpha, n)
    with pytest.raises(ValueError):
        t_runtime.subsample_time_ratio(0.0, 10)


def test_tabular_equals_jax():
    for dims in ((3, 4), (1, 1, 5)):
        t_part, j_part = (t_tabular.partition_from_dims(dims),
                          j_tabular.partition_from_dims(dims))
        assert tuple(t_part) == tuple(j_part)
        assert t_part.dims() == j_part.dims()
        assert [t_part.owner_of(f) for f in range(t_part.num_features)] == \
            [j_part.owner_of(f) for f in range(j_part.num_features)]
    assert tuple(t_tabular.even_partition(12, 4)) == \
        tuple(j_tabular.even_partition(12, 4))
    with pytest.raises(ValueError):
        t_tabular.even_partition(10, 4)
    x = np.random.default_rng(0).normal(size=(5, 23)).astype(np.float32)
    for parties in (2, 4, 23):
        got, want = t_tabular.pad_features(x, parties), \
            j_tabular.pad_features(x, parties)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    got = t_tabular.load_csv(str(CSV), max_rows=300)
    want = j_tabular.load_csv(str(CSV), max_rows=300)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.name, got.active_dims) == (want.name, want.active_dims)
    a, b = np.array([5, 1, 9, 3]), np.array([3, 9, 7])
    np.testing.assert_array_equal(t_tabular.aligned_intersection(a, b),
                                  j_tabular.aligned_intersection(a, b))
