"""The port's examples (``repro_torch.examples``) in-process on the CPU at
reduced sizes, with their checks: AUC above chance, every federated run's
wire ledger reconciled with the run's own meter, the LM loss finite."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.examples import (
    embeddings_head,
    lm_pretrain_e2e,
    quickstart,
    vfl_credit_scoring,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def test_quickstart():
    out = quickstart.main("cpu", n=3000, rounds=4)
    for name in ("dynamic_fedgbf", "secureboost"):
        assert out[name]["auc"] > 0.5
    assert sum(out["party_importance"].values()) == pytest.approx(1.0)
    lo, hi = out["runtime_units"]["fedgbf"]
    assert 0 < lo <= hi and out["runtime_units"]["secureboost"] == 4.0


def test_vfl_credit_scoring():
    """Each of the four runs trains above chance; its ledger reconciles
    (the example raises otherwise) and equals the run's own meter."""
    runs = vfl_credit_scoring.main("cpu", n=2000, rounds=3)
    assert [r["tag"] for r in runs] == ["histogram", "argmax",
                                        "histogram-q8", "histogram-q8+sub"]
    for r in runs:
        assert r["auc"] > 0.5
        assert all(v["delta"] == 0 for v in r["reconcile"].values())
        assert r["paillier_bytes"] > r["reconcile"]["total"]["measured"]
    # lossless modes build the same model
    assert runs[0]["auc"] == runs[1]["auc"]
    raw, q8 = (r["reconcile"]["histograms"]["measured"] for r in runs[::2])
    assert q8 < raw / 4


def test_embeddings_head():
    rep = embeddings_head.main("cpu", n=800, seq=16, rounds=5)
    assert rep["auc"] > 0.7


def test_lm_pretrain_e2e_quick():
    run = lm_pretrain_e2e.main("cpu", quick=True, steps=4)
    assert len(run["losses"]) == 4 and np.isfinite(run["losses"]).all()
