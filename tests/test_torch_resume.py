"""Kill-and-resume on the CPU: the port's start/stop window and its
train-state checkpoints, within the port and across the packages.

A run stopped after some rounds, checkpointed (``save_train_state``: the
packed prefix, the exact float32 margins, the completed-round count and a
configuration fingerprint) and resumed from the stored margins must give
the uninterrupted run's packed ensemble byte for byte, as the JAX
package's ``tests/test_fault.py`` requires of itself.  Across packages:
the JAX package trains the first rounds and writes the state, the port
loads it and finishes from the state's run key (drawing the JAX masks
itself), and the stitched model is the JAX full run's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as j_io
from repro.core import boosting as j_boosting
from repro_torch.checkpoint import io as t_io
from repro_torch.core import boosting as t_boosting
from repro_torch.core import prng
from repro_torch.core.types import (
    PACKED_ARRAYS,
    EnsembleModel,
    pack_ensemble,
    unpack_ensemble,
)
from repro_torch.data import synthetic as t_synthetic
from torch_parity import jax_config


def _packed_bytes(model) -> list:
    packed = pack_ensemble(model)
    return [getattr(packed, f).numpy().tobytes() for f in PACKED_ARRAYS]


def _stitch(prefix, model):
    return EnsembleModel(
        forests=prefix.forests + model.forests,
        learning_rate=model.learning_rate, base_score=model.base_score,
        bin_edges=model.bin_edges, loss=model.loss,
        max_depth=model.max_depth)


@pytest.mark.parametrize("sampling", ["uniform", "goss"])
def test_resume_equals_uninterrupted(sampling, tmp_path):
    """Rounds [0, 3), a train-state checkpoint, then [3, 6) from the
    stored margins: the stitched ensemble, the history and the final
    margins equal the uninterrupted run's (``test_fault.py:150-188``)."""
    ds = t_synthetic.load("default_credit_card", n=400)
    xv, yv = ds.x_test[:150], ds.y_test[:150]
    cfg = t_boosting.dynamic_fedgbf_config(rounds=6, sampling=sampling)
    kw = dict(x_valid=xv, y_valid=yv, eval_every=2, device="cpu",
              backend="local-cuda")
    full, full_hist = t_boosting.train_fedgbf(ds.x_train, ds.y_train, cfg,
                                              **kw)
    m1, h1 = t_boosting.train_fedgbf(ds.x_train, ds.y_train, cfg,
                                     stop_round=3, **kw)
    path = str(tmp_path / "seg")
    t_io.save_train_state(path, m1, margin=h1.final_margin,
                          completed_rounds=3, fingerprint="fp",
                          margin_valid=h1.final_margin_valid)
    state = t_io.load_train_state(path, device="cpu")
    assert state["completed_rounds"] == 3 and state["rng_key"] is None
    m2, h2 = t_boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, start_round=3,
        init_margin=state["margin"], init_margin_valid=state["margin_valid"],
        **kw)
    assert h2.start_round == 3 and h2.n_trees == full_hist.n_trees[3:]
    stitched = _stitch(unpack_ensemble(state["packed"]), m2)
    assert _packed_bytes(stitched) == _packed_bytes(full)
    assert h1.rounds + h2.rounds == full_hist.rounds == [2, 4, 6]
    assert h1.train + h2.train == full_hist.train
    assert h1.valid + h2.valid == full_hist.valid
    np.testing.assert_array_equal(h2.final_margin, full_hist.final_margin)
    np.testing.assert_array_equal(h2.final_margin_valid,
                                  full_hist.final_margin_valid)


@pytest.mark.parametrize("sampling", ["uniform", "goss"])
def test_cross_package_resume(sampling, tmp_path):
    """The JAX package trains rounds [0, 3) and writes the train state;
    the port loads it and trains [3, 5) from the state's key; the stitched
    packed ensemble is the JAX full run's, array for array and byte for
    byte."""
    ds = t_synthetic.load("default_credit_card", n=400)
    cfg = t_boosting.dynamic_fedgbf_config(rounds=5, sampling=sampling)
    j_cfg = jax_config(cfg)
    x, y = jnp.asarray(ds.x_train), jnp.asarray(ds.y_train)
    j_full, _ = j_boosting.train_fedgbf(x, y, j_cfg, jax.random.PRNGKey(0))
    j_part, j_hist = j_boosting.train_fedgbf(x, y, j_cfg,
                                             jax.random.PRNGKey(0),
                                             stop_round=3)
    path = str(tmp_path / "jax-state")
    j_io.save_train_state(path, j_part, margin=j_hist.final_margin,
                          completed_rounds=3, fingerprint="fp",
                          rng_key=jax.random.PRNGKey(0))
    state = t_io.load_train_state(path, device="cpu")
    np.testing.assert_array_equal(state["rng_key"],
                                  np.asarray(jax.random.PRNGKey(0)))
    model, hist = t_boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, prng.as_key(state["rng_key"]),
        start_round=3, init_margin=state["margin"], backend="local-cuda",
        device="cpu")
    stitched = pack_ensemble(_stitch(unpack_ensemble(state["packed"]),
                                     model))
    from repro.core.types import pack_ensemble as j_pack

    want = j_pack(j_full)
    for f in PACKED_ARRAYS:
        got = getattr(stitched, f).numpy()
        assert got.tobytes() == np.asarray(getattr(want, f)).tobytes(), f
    assert stitched.round_offsets == want.round_offsets


def test_train_state_and_pytree_roundtrip_both_ways(tmp_path):
    """The port's train state loads in the JAX package and the reverse
    (margins, valid margins, key, fingerprint, history); ``save_pytree`` /
    ``load_pytree`` move flat lists, bfloat16 included, both ways."""
    ds = t_synthetic.load("default_credit_card", n=300)
    cfg = t_boosting.dynamic_fedgbf_config(rounds=2)
    model, hist = t_boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, x_valid=ds.x_test[:50],
        y_valid=ds.y_test[:50], device="cpu")
    path = str(tmp_path / "port-state")
    key = np.array([0, 7], np.uint32)
    t_io.save_train_state(path, model, hist.final_margin, 2, "fp-port",
                          rng_key=key, margin_valid=hist.final_margin_valid,
                          history={"rounds": hist.rounds})
    js = j_io.load_train_state(path)
    packed = pack_ensemble(model)
    for f in PACKED_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(js["packed"], f)),
                                      getattr(packed, f).numpy(), f)
    assert js["packed"].round_offsets == packed.round_offsets
    np.testing.assert_array_equal(js["margin"], hist.final_margin)
    np.testing.assert_array_equal(js["margin_valid"],
                                  hist.final_margin_valid)
    np.testing.assert_array_equal(js["rng_key"], key)
    assert (js["completed_rounds"], js["config_fingerprint"],
            js["history"]) == (2, "fp-port", {"rounds": [1, 2]})
    jpath = str(tmp_path / "jax-state")
    j_io.save_train_state(jpath, js["packed"], js["margin"], 2, "fp-jax")
    ts = t_io.load_train_state(jpath, device="cpu")
    assert ts["margin_valid"] is None and ts["rng_key"] is None
    assert ts["config_fingerprint"] == "fp-jax"
    assert _packed_bytes(unpack_ensemble(ts["packed"])) == \
        _packed_bytes(model)
    with pytest.raises(ValueError, match="train state"):
        t_io.load_ensemble(jpath, device="cpu")
    j_io.save_pytree(str(tmp_path / "tree"), [jnp.ones(2)])
    with pytest.raises(ValueError, match="not a train-state"):
        t_io.load_train_state(str(tmp_path / "tree"), device="cpu")

    leaves = [torch.arange(6, dtype=torch.int32).reshape(2, 3),
              torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
              torch.zeros(0)]
    t_io.save_pytree(str(tmp_path / "flat"), leaves, {"note": 1})
    got = j_io.load_pytree(str(tmp_path / "flat"), [0, 0, 0])
    assert got[1].dtype == jnp.bfloat16
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    j_io.save_pytree(str(tmp_path / "jflat"), [np.asarray(g) for g in got])
    back = t_io.load_pytree(str(tmp_path / "jflat"), device="cpu")
    assert [t.dtype for t in back] == [t.dtype for t in leaves]
    for a, b in zip(back, leaves):
        assert torch.equal(a, b)
    with open(str(tmp_path / "flat.meta.json")) as f:
        assert json.load(f)["note"] == 1


def test_resume_argument_validation():
    """The JAX package's ``ValueError``s (``test_fault.py:191-199``), and
    its ``round_feature_mask`` shape check (``boosting.py:177-183``)."""
    ds = t_synthetic.load("default_credit_card", n=64)
    cfg = t_boosting.secureboost_config(rounds=4)

    def train(**kw):
        t_boosting.train_fedgbf(ds.x_train, ds.y_train, cfg, device="cpu",
                                **kw)

    with pytest.raises(ValueError, match="start_round"):
        train(start_round=2)
    with pytest.raises(ValueError, match="init_margin"):
        train(init_margin=np.zeros(ds.x_train.shape[0], np.float32))
    with pytest.raises(ValueError, match="round window"):
        train(stop_round=9)
    with pytest.raises(ValueError, match="unknown sampling"):
        t_boosting.train_fedgbf(ds.x_train, ds.y_train,
                                dataclasses.replace(cfg, sampling="top"),
                                device="cpu")
    with pytest.raises(ValueError, match="round_feature_mask shape"):
        train(round_feature_mask=np.ones((3, ds.x_train.shape[1]), bool))


def test_launcher_kill_and_resume(tmp_path, capsys):
    """``--checkpoint P --checkpoint-every 2 --stop-after-round 3``, then
    ``--resume``: the state's packed model equals an uninterrupted run's;
    a changed configuration refuses to resume; GOSS runs too."""
    from repro_torch.launch import train_fedgbf as t_cli

    base = ["--device", "cpu", "--rounds", "4", "--n", "400",
            "--backend", "local"]
    part, whole = str(tmp_path / "part"), str(tmp_path / "whole")
    t_cli.main([*base, "--checkpoint", part, "--checkpoint-every", "2",
                "--stop-after-round", "3"])
    out = capsys.readouterr().out
    assert "checkpoint: 2 rounds" in out and "checkpoint: 3 rounds" in out
    assert "stopped after round 3" in out
    assert t_io.load_train_state(part, device="cpu")["completed_rounds"] == 3
    t_cli.main([*base, "--checkpoint", part, "--checkpoint-every", "2",
                "--resume"])
    out = capsys.readouterr().out
    assert "resume: 3 completed rounds" in out and "[round   4]" in out
    assert "[round   3]" not in out
    t_cli.main([*base, "--checkpoint", whole])
    resumed = t_io.load_train_state(part, device="cpu")
    uninterrupted = t_io.load_train_state(whole, device="cpu")
    assert resumed["completed_rounds"] == uninterrupted[
        "completed_rounds"] == 4
    for f in PACKED_ARRAYS:
        assert torch.equal(getattr(resumed["packed"], f),
                           getattr(uninterrupted["packed"], f)), f
    np.testing.assert_array_equal(resumed["margin"], uninterrupted["margin"])
    with pytest.raises(SystemExit, match="fingerprint"):
        t_cli.main([*base, "--sampling", "goss", "--checkpoint", part,
                    "--resume"])
    capsys.readouterr()
    t_cli.main([*base, "--sampling", "goss", "--rounds", "2"])
    out = capsys.readouterr().out
    assert "sampling=goss" in out and "TEST: auc=" in out
