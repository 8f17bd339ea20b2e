"""Port vs JAX package: the federation runtime (retries and party
dropout) on the CPU.

* ``dropout_schedule``, ``degradation_masks``, ``degraded_parties`` and
  ``RetryPolicy.backoff`` equal the JAX package's exactly (numpy streams);
* ``train_fedgbf(round_feature_mask=...)``, ``local`` and
  ``vfl-histogram``, given the JAX masks, trains the JAX package's masked
  model bit for bit, and no tree splits on a degraded column;
* a table where every party is degraded in some round raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as j_boosting
from repro.core.types import pack_ensemble as j_pack
from repro.federation import runtime as j_runtime
from repro_torch.convert import masks_from_numpy
from repro_torch.core import backend as t_backend
from repro_torch.core import boosting as t_boosting
from repro_torch.core.types import FedGBFConfig, TreeConfig, pack_ensemble
from repro_torch.federation import runtime as t_runtime
from repro_torch.federation import selftest as t_selftest
from torch_parity import jax_config, jax_step_masks


@pytest.mark.parametrize("rate,rounds,parties,seed,retries", [
    (0.6, 4, 4, 11, 0), (0.3, 20, 4, 0, 3), (0.9, 7, 3, 5, 1),
    (0.0, 5, 2, 1, 2), (0.5, 12, 6, 123, 4)])
def test_dropout_schedule_equals_jax(rate, rounds, parties, seed, retries):
    """Degraded cells, retries, simulated backoff, the per-round summaries
    and the degraded parties: the JAX schedule, array for array."""
    t = t_runtime.dropout_schedule(rate, rounds, parties, seed=seed,
                                   policy=t_runtime.RetryPolicy(
                                       max_retries=retries))
    j = j_runtime.dropout_schedule(rate, rounds, parties, seed=seed,
                                   policy=j_runtime.RetryPolicy(
                                       max_retries=retries))
    np.testing.assert_array_equal(t.degraded, j.degraded)
    np.testing.assert_array_equal(t.retries, j.retries)
    assert t.retries.dtype == j.retries.dtype
    assert t.backoff_s == j.backoff_s
    assert t.degraded_rounds == j.degraded_rounds
    assert [t.round_summary(m) for m in range(rounds)] == \
        [j.round_summary(m) for m in range(rounds)]
    assert t_runtime.degraded_parties(t) == j_runtime.degraded_parties(j)


def test_degradation_masks_and_backoff_equal_jax():
    """Masks of random degradation tables (None when nothing degrades),
    the column slices, and the capped exponential backoff."""
    rng = np.random.default_rng(0)
    for parties, d in ((2, 6), (4, 8), (3, 9)):
        for _ in range(5):
            table = rng.random((6, parties)) < 0.3
            table[:, 0] = False   # never every party in a round
            got = t_runtime.degradation_masks(table, d, parties)
            want = j_runtime.degradation_masks(table, d, parties)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
        for p in range(parties):
            assert t_runtime.party_column_slice(p, d, parties) == \
                j_runtime.party_column_slice(p, d, parties)
    for kw in ({}, dict(base_delay_s=0.2, max_delay_s=1.0, max_retries=7)):
        t, j = t_runtime.RetryPolicy(**kw), j_runtime.RetryPolicy(**kw)
        assert [t.backoff(a) for a in range(12)] == \
            [j.backoff(a) for a in range(12)]
    with pytest.raises(ValueError, match="max_retries"):
        t_runtime.RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="dropout rate"):
        t_runtime.dropout_schedule(1.0, 3, 2)


def test_all_degraded_raises():
    """A round with every party degraded leaves no candidate: both
    packages raise the same ``ValueError``."""
    table = np.array([[False, True], [True, True], [False, False]])
    with pytest.raises(ValueError, match="round 2: every party degraded"):
        t_runtime.degradation_masks(table, 4, 2)
    with pytest.raises(ValueError, match="round 2: every party degraded"):
        j_runtime.degradation_masks(table, 4, 2)
    with pytest.raises(ValueError, match="not divisible"):
        t_runtime.party_column_slice(0, 5, 2)


def _degradation_case():
    """``selftest.check_degradation``'s data and mask (4 parties, 512
    rows, 4 rounds; rate 0.6 without retries, seed 11)."""
    parties, n = 4, 512
    cfg = FedGBFConfig(rounds=4, n_trees_max=3, n_trees_min=2,
                       rho_id_min=0.5, rho_id_max=0.8,
                       tree=TreeConfig(max_depth=3, num_bins=16))
    rng = np.random.default_rng(3)
    d = parties * 2
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.normal(size=n) + x[:, 0] > 0).astype(np.float32)
    sched = t_runtime.dropout_schedule(
        0.6, cfg.rounds, parties, seed=11,
        policy=t_runtime.RetryPolicy(max_retries=0))
    mask = t_runtime.degradation_masks(sched.degraded, d, parties)
    assert mask is not None and not mask.all()
    return parties, cfg, x, y, mask


@pytest.mark.parametrize("backend", ["local", "vfl-histogram"])
def test_masked_run_equals_jax(backend):
    """The masked run, given the JAX masks: every packed array and the
    final margins equal the JAX package's masked ``local`` run (the scan
    engine), bit for bit; no split on a degraded column."""
    parties, cfg, x, y, mask = _degradation_case()
    j_cfg = jax_config(cfg)
    j_model, j_hist = j_boosting.train_fedgbf(
        jnp.asarray(x), jnp.asarray(y), j_cfg, jax.random.PRNGKey(0),
        round_feature_mask=mask, engine="scan")
    smask, fmask = jax_step_masks(j_cfg, *x.shape)
    bk = (backend if backend == "local" else t_backend.get_backend(
        backend, tree=cfg.tree, num_parties=parties))
    model, hist = t_boosting.train_fedgbf(
        x, y, cfg, masks=masks_from_numpy(smask, fmask, device="cpu"),
        backend=bk, device="cpu", round_feature_mask=mask)
    packed = pack_ensemble(model)
    j_packed = j_pack(j_model)
    for f in ("feature", "threshold", "gain", "leaf_weight", "tree_scale",
              "bin_edges"):
        np.testing.assert_array_equal(getattr(packed, f).numpy(),
                                      np.asarray(getattr(j_packed, f)), f)
    np.testing.assert_array_equal(hist.final_margin,
                                  np.asarray(j_hist.final_margin))
    t_selftest.assert_no_banned_splits(packed, mask)
    unmasked, _ = t_boosting.train_fedgbf(
        x, y, cfg, masks=masks_from_numpy(smask, fmask, device="cpu"),
        backend=bk, device="cpu")
    assert not all(torch.equal(a.feature, b.feature)
                   for a, b in zip(unmasked.forests, model.forests))


def test_launcher_runtime_flags(capsys):
    """The JAX launcher's runtime flags: chaos rates select the ``-chaos``
    twin, party dropout prints its summary and the gradient-less fallback
    one line per degraded party, ``--data-shards 2`` runs the ``-sharded``
    name and is refused on any other; the ledger matches throughout."""
    from repro_torch.launch import train_fedgbf as t_cli

    base = ["--device", "cpu", "--rounds", "2", "--n", "600", "--parties",
            "4"]
    t_cli.main(base + ["--backend", "vfl-histogram", "--chaos-drop", "0.3",
                       "--chaos-corrupt", "0.2", "--chaos-seed", "3",
                       "--party-dropout", "0.5", "--retry-max", "0",
                       "--dropout-fallback", "gradientless", "--log-json"])
    out = capsys.readouterr().out
    assert "backend=vfl-histogram-chaos: 4 parties x 1 data shards" in out
    assert "(match=True)" in out and "party-dropout: " in out
    assert '"faults":{' in out and "gradientless fallback: party" in out
    t_cli.main(base + ["--backend", "vfl-histogram-sharded",
                       "--data-shards", "2"])
    out = capsys.readouterr().out
    assert "backend=vfl-histogram-sharded: 4 parties x 2 data shards" in out
    assert "(match=True)" in out
    with pytest.raises(SystemExit, match="need a -sharded backend"):
        t_cli.main(base + ["--backend", "vfl-argmax", "--data-shards", "2"])
    with pytest.raises(SystemExit, match="needs a vfl-\\* backend"):
        t_cli.main(base + ["--backend", "local", "--chaos-drop", "0.1"])
