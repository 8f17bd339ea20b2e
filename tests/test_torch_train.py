"""Port vs JAX package: ``train_fedgbf`` end to end, the launchers'
training paths and the 20-round reference run (CPU).

The port draws its masks from the same key as the JAX scan engine
(``core/prng.py``), or takes explicit masks.  Trees must be exact (the port reproduces
XLA's CPU arithmetic where it matters: ``exp``, the blocked cumsum, the FMA
of the margin update); final margins exact on the reference run and within
1e-6 elsewhere; history metrics 1e-5.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as j_boosting
from repro.data import synthetic as j_synthetic
from repro_torch.checkpoint import io as t_io
from repro_torch.core import boosting as t_boosting
from repro_torch.core import dynamic as t_dynamic
from repro_torch.core import forest as t_forest
from repro_torch.core import prng
from repro_torch.core.types import TreeConfig as TTreeConfig
from repro_torch.core.types import pack_ensemble
from repro_torch.data import synthetic as t_synthetic
from test_torch_reference import CKPT, METRIC_KEYS, TRAIN
from torch_parity import assert_trees_equal, jax_config, jax_step_masks

ATOL = 1e-5


def _train_both(t_cfg, ds, backend, eval_every=1, valid=False):
    """Both packages from ``PRNGKey(0)`` alone: the port draws the JAX
    scan engine's masks itself."""
    j_cfg = jax_config(t_cfg)
    vkw = dict(x_valid=ds.x_test, y_valid=ds.y_test) if valid else {}
    jm, jh = j_boosting.train_fedgbf(
        jnp.asarray(ds.x_train), jnp.asarray(ds.y_train), j_cfg,
        jax.random.PRNGKey(0), eval_every=eval_every,
        **{k: jnp.asarray(v) for k, v in vkw.items()})
    tm, th = t_boosting.train_fedgbf(
        ds.x_train, ds.y_train, t_cfg, prng.PRNGKey(0), backend=backend,
        eval_every=eval_every, device="cpu", **vkw)
    return (jm, jh), (tm, th)


def _assert_same_run(j, t):
    (jm, jh), (tm, th) = j, t
    assert len(tm.forests) == len(jm.forests)
    for tf, jf in zip(tm.forests, jm.forests):
        assert_trees_equal(tf, jf)
    np.testing.assert_array_equal(tm.bin_edges.numpy(),
                                  np.asarray(jm.bin_edges))
    # Margins: XLA fuses the update ``y + lr * mean`` into one FMA in the
    # reference run's program (exact there, test below), but whether it
    # does depends on how the scan engine's program is cut into segments:
    # the JAX package's own windowed and whole runs of one schedule differ
    # by an ulp.  So an ulp here, and trees exact.
    np.testing.assert_allclose(th.final_margin, jh.final_margin, rtol=0,
                               atol=1e-6)
    if jh.final_margin_valid is not None:
        np.testing.assert_allclose(th.final_margin_valid,
                                   jh.final_margin_valid, rtol=0, atol=1e-6)
    assert th.rounds == jh.rounds and th.n_trees == jh.n_trees
    assert th.rho_id == jh.rho_id
    for got, want in zip(th.train + th.valid, jh.train + jh.valid):
        assert got.keys() == want.keys()
        for key in got:
            assert abs(got[key] - want[key]) <= ATOL, key
    assert len(th.wall_time_s) == len(th.n_trees)
    assert sum(s["rounds"] for s in th.segments) == len(th.n_trees)


@pytest.mark.parametrize("backend", ["local", "local-cuda"])
def test_dynamic_fedgbf_equals_jax_scan(backend):
    ds = t_synthetic.load("default_credit_card", n=2000)
    cfg = t_boosting.dynamic_fedgbf_config(rounds=4)
    _assert_same_run(*_train_both(cfg, ds, backend, eval_every=2,
                                  valid=True))


def test_shared_root_and_multiclass_equal_jax_scan():
    ds = t_synthetic.load("default_credit_card", n=1500)
    cfg = t_boosting.FedGBFConfig(
        rounds=3, n_trees_max=3, n_trees_min=2, rho_id_min=0.45,
        rho_id_max=0.7, tree=TTreeConfig(shared_root=True))
    (jm, jh), (tm, th) = _train_both(cfg, ds, "local-cuda")
    _assert_same_run((jm, jh), (tm, th))
    plan = t_boosting._plan_segments(cfg, ds.x_train.shape[0])
    assert plan == j_boosting._plan_segments(jax_config(cfg),
                                             ds.x_train.shape[0])
    assert [seg["root_delta_rows"] for seg in th.segments] == [
        p[3] for p in plan] and any(p[3] for p in plan)
    ds3 = t_synthetic.load("credit_risk_tiers", n=1500)
    cfg3 = t_boosting.FedGBFConfig(rounds=2, n_trees_max=2, n_trees_min=2,
                                   rho_id_min=0.5, rho_id_max=0.5,
                                   loss="softmax3")
    _assert_same_run(*_train_both(cfg3, ds3, "local-cuda"))


def test_reference_run_reproduces_checkpoint():
    """The 20-round reference run on the CPU from ``PRNGKey(0)`` alone (no
    masks input; the committed masks are what that key draws,
    ``test_torch_prng.py``): the 78 trees of the committed checkpoint, its
    bin edges, its leaves, and the JAX run's history and final margins."""
    ds = t_synthetic.load("default_credit_card")
    z = np.load(TRAIN)
    model, hist = t_boosting.train_fedgbf(
        ds.x_train, ds.y_train, t_boosting.dynamic_fedgbf_config(rounds=20),
        prng.PRNGKey(0), backend="local-cuda", device="cpu")
    packed = pack_ensemble(model)
    ckpt = t_io.load_ensemble(str(CKPT), device="cpu")
    assert packed.total_trees == 78
    assert packed.round_offsets == ckpt.round_offsets
    for field in ("bin_edges", "feature", "threshold"):
        assert torch.equal(getattr(packed, field), getattr(ckpt, field)), \
            field
    np.testing.assert_allclose(packed.leaf_weight.numpy(),
                               ckpt.leaf_weight.numpy(), rtol=0, atol=ATOL)
    got = np.array([[r[k] for k in METRIC_KEYS] for r in hist.train])
    np.testing.assert_allclose(got, z["train_metrics"], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(hist.final_margin, z["final_margin"])


def test_native_sampler_keep_counts():
    """``draw_step_masks`` from a key: the scheduled keep counts, the same
    masks again, and the JAX scan engine's masks of that key."""
    cfg = t_boosting.FedGBFConfig(rounds=6, n_trees_max=4, n_trees_min=2,
                                  rho_id_min=0.1, rho_id_max=0.3,
                                  rho_feat=0.6)
    masks = t_forest.draw_step_masks(cfg, 1000, 10, prng.PRNGKey(3))
    sched, flat = t_dynamic.flat_schedule(cfg)
    keep = t_boosting._keep_counts(cfg, 1000)[flat.round_of_step]
    assert masks.sample.shape == (int(sched.n_trees.sum()), 1000)
    np.testing.assert_array_equal(masks.sample.sum(1).numpy(), keep)
    assert (masks.feature.sum(1) == 6).all()
    again = t_forest.draw_step_masks(cfg, 1000, 10, prng.PRNGKey(3))
    assert torch.equal(again.sample, masks.sample)
    smask, fmask = jax_step_masks(jax_config(cfg), 1000, 10,
                                  key=jax.random.PRNGKey(3))
    np.testing.assert_array_equal(masks.sample.numpy(), smask)
    np.testing.assert_array_equal(masks.feature.numpy(), fmask)


def test_unported_options_and_no_fallback():
    """A party-dropout mask of the wrong shape; GOSS takes GOSS draws,
    not sample masks; wrong shapes and a missing card raise."""
    ds = t_synthetic.load("default_credit_card", n=300)
    cfg = t_boosting.dynamic_fedgbf_config(rounds=2)
    uniform = t_forest.draw_step_masks(cfg, 210, 23, prng.PRNGKey(0))
    with pytest.raises(TypeError, match="GossDraws"):
        t_boosting.train_fedgbf(ds.x_train, ds.y_train,
                                dataclasses.replace(cfg, sampling="goss"),
                                masks=uniform, device="cpu")
    with pytest.raises(ValueError, match="round_feature_mask shape"):
        t_boosting.train_fedgbf(ds.x_train, ds.y_train, cfg, device="cpu",
                                round_feature_mask=np.ones((2, 22), bool))
    bad = t_forest.StepMasks(torch.ones(3, 210), torch.ones(3, 23,
                                                            dtype=bool))
    with pytest.raises(ValueError, match="scheduled builds"):
        t_boosting.train_fedgbf(ds.x_train, ds.y_train, cfg, masks=bad,
                                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_boosting.train_fedgbf(ds.x_train, ds.y_train, cfg)


def _round_lines(text):
    """{round: [numbers]} from the ``[round NNN] ...`` lines, plus the
    TEST line's numbers under key 0."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"\[round +(\d+)\] (.*)", line)
        if m:
            out[int(m.group(1))] = [float(v) for v in re.findall(
                r"=([-\d.]+)", m.group(2))]
        elif line.startswith("TEST:"):
            out[0] = [float(v) for v in re.findall(r"=([-\d.]+)", line)]
    return out


def test_train_cli_reconciles_with_jax_launcher(tmp_path, capsys,
                                                monkeypatch):
    from repro.launch import train_fedgbf as j_cli
    from repro_torch.launch import train_fedgbf as t_cli

    args = ["--rounds", "3", "--n", "2000"]
    monkeypatch.setattr("sys.argv", ["train_fedgbf", *args])
    j_cli.main()
    want = _round_lines(capsys.readouterr().out)
    # the port at its defaults: the masks drawn from PRNGKey(0)
    ckpt = tmp_path / "model"
    trace = tmp_path / "trace.json"
    t_cli.main([*args, "--device", "cpu", "--checkpoint", str(ckpt),
                "--trace", str(trace)])
    got = _round_lines(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1.5e-4)
    state = t_io.load_train_state(str(ckpt), device="cpu")
    assert state["completed_rounds"] == 3
    assert state["packed"].total_trees == 11
    assert trace.stat().st_size > 0
    # --masks overrides the draw (here with the draw itself, in the file's
    # packed-bits format)
    ds = j_synthetic.load("default_credit_card", n=600)
    drawn = t_forest.draw_step_masks(t_boosting.dynamic_fedgbf_config(2),
                                     *ds.x_train.shape, prng.PRNGKey(0))
    masks = tmp_path / "masks.npz"
    np.savez(masks, sample_bits=np.packbits(
        drawn.sample.numpy().astype(np.uint8), axis=1),
        feature=drawn.feature.numpy(), n=ds.x_train.shape[0])
    t_cli.main(["--device", "cpu", "--rounds", "2", "--n", "600",
                "--backend", "local", "--log-json", "--masks", str(masks)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"event":"round"')]
    assert len(lines) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_cli.main(["--rounds", "1", "--n", "300"])


def test_serve_trains_without_checkpoint(tmp_path, capsys):
    from repro_torch.launch import serve_fedgbf as t_serve

    saved = tmp_path / "served"
    t_serve.main(["--device", "cpu", "--rounds", "2", "--requests", "3000",
                  "--save", str(saved)])
    out = capsys.readouterr().out
    assert "trained 7 trees / 2 rounds" in out
    assert "score head" in out
    packed = t_io.load_ensemble(str(saved), device="cpu")
    assert packed.total_trees == 7 and packed.rounds == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_serve.main(["--rounds", "1", "--requests", "100"])

