"""Port vs JAX package: core types, value-space thresholds, packing, the
objective activations and the device resolver (CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import objective as j_objective
from repro.core import types as j_types
from repro_torch import device as t_device
from repro_torch.core import objective as t_objective
from repro_torch.core import types as t_types
from torch_parity import FIELDS, random_packed_arrays


@pytest.mark.parametrize("name", ["TreeConfig", "FedGBFConfig"])
def test_config_fields_and_defaults_match(name):
    j_cls, t_cls = getattr(j_types, name), getattr(t_types, name)
    assert ([f.name for f in dataclasses.fields(j_cls)]
            == [f.name for f in dataclasses.fields(t_cls)])
    assert dataclasses.asdict(j_cls()) == dataclasses.asdict(t_cls())


def test_float_thresholds_exact():
    """Value-space thresholds, unsplit sentinels and the clamped gathers
    (feature -1, threshold B - 1 and B, a feature id past d) agree exactly."""
    rng = np.random.default_rng(0)
    arrays, _ = random_packed_arrays(rng, [6, 4], 4, 9)
    feature, threshold = arrays["feature"], arrays["threshold"]
    threshold[0, :3] = [30, 31, 32]            # B - 2 split, B - 1 and B not
    feature[1, 0] = 12                         # past d: both clamp to d - 1
    edges = arrays["bin_edges"]
    want = np.asarray(j_types.float_thresholds(
        jnp.asarray(feature), jnp.asarray(threshold), jnp.asarray(edges)))
    got = t_types.float_thresholds(
        torch.from_numpy(feature), torch.from_numpy(threshold),
        torch.from_numpy(edges)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got == t_types.FLOAT_MAX).any() and t_types.FLOAT_MAX == \
        j_types.FLOAT_MAX


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(1)
    arrays, meta = random_packed_arrays(rng, [5, 3, 2], 3, 7, lr=0.3)
    offs = meta["round_offsets"]

    def forests(mod, conv):
        return tuple(mod.TreeArrays(*(conv(arrays[f][s:e]) for f in FIELDS[:4]))
                     for s, e in zip(offs[:-1], offs[1:]))

    j_model = j_types.EnsembleModel(
        forests(j_types, jnp.asarray), 0.3, 0.25,
        jnp.asarray(arrays["bin_edges"]), "logistic", 3)
    t_model = t_types.EnsembleModel(
        forests(t_types, torch.from_numpy), 0.3, 0.25,
        torch.from_numpy(arrays["bin_edges"]), "logistic", 3)
    jp, tp = j_types.pack_ensemble(j_model), t_types.pack_ensemble(t_model)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert tp.round_offsets == jp.round_offsets == tuple(offs)
    assert (tp.total_trees, tp.rounds) == (10, 3)
    back = t_types.unpack_ensemble(tp)
    for a, b in zip(back.forests, t_model.forests):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    assert tp.to("cpu").device == torch.device("cpu")


@pytest.mark.parametrize("loss", ["logistic", "squared", "quantile@0.25",
                                  "softmax3", "softmax1"])
def test_activations_match_jax(loss):
    rng = np.random.default_rng(2)
    k = j_objective.get_objective(loss).n_classes
    m = rng.normal(scale=4.0, size=(257,) if k == 1 else (257, k)).astype(
        np.float32)
    want = np.asarray(j_objective.get_objective(loss).activation(
        jnp.asarray(m)))
    got = t_objective.get_objective(loss).activation(torch.from_numpy(m))
    assert t_objective.get_objective(loss).n_classes == k
    # torch.sigmoid / softmax and JAX's may differ in the last ulp
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", ["softmax0", "softmaxx", "quantile@1.5",
                                 "quantiles", "hinge"])
def test_bad_objective_names_refused(bad):
    with pytest.raises(ValueError):
        j_objective.get_objective(bad)
    with pytest.raises(ValueError):
        t_objective.get_objective(bad)


def test_device_resolve_never_falls_back(monkeypatch):
    assert t_device.resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_device.resolve(name)
