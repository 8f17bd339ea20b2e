"""The port's FedGBF production-grid round (``launch/dryrun_fedgbf.py``) on
the CPU at a small size: 2,048 rows, 16 parties, 4 row shards.

Every run's meter reconciles with the wire model (delta 0, the run's own
meter equal to the ledger); the histogram, async and argmax trees equal
``local-cuda``'s (here its plain version); async over sync is exactly 1;
the subtraction and compaction cuts equal the JAX package's wire model's
(``repro/federation/protocol.py``, plain arithmetic) for the same configs.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

from repro.core.types import FedGBFConfig as JaxFedGBFConfig
from repro.federation import protocol as j_protocol
from repro_torch.launch import dryrun_fedgbf
from repro_torch.obs.trace import Tracer

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

N, SHARDS, PARTIES = 2048, 4, 16


def jax_exchange_bytes(hist_subtraction: bool, max_depth: int,
                       max_active_nodes: int = 0) -> int:
    """The JAX wire model's bytes of one 5-tree round on 16 parties over 4
    row shards, but the (g, h) broadcast."""
    spec = j_protocol.ProtocolSpec(
        n_samples=N, party_dims=(1,) * PARTIES, num_bins=32,
        max_depth=max_depth, aggregation="histogram",
        hist_subtraction=hist_subtraction,
        max_active_nodes=max_active_nodes, data_shards=SHARDS)
    cost = j_protocol.wire_run_cost(
        spec, JaxFedGBFConfig(rounds=1, n_trees_max=5, n_trees_min=5))
    return cost["total"] - cost["grad_broadcast"]


@pytest.fixture(scope="module")
def runs():
    """The sweep's runs on the (4 x 16) grid: {name: report}."""
    cache: dict = {}
    tracer = Tracer()
    kw = dict(n=N, data_shards=SHARDS, device="cpu", cache=cache,
              save=False, tracer=tracer)
    out = {
        "histogram": dryrun_fedgbf.run("histogram", oracle=True, **kw),
        "async": dryrun_fedgbf.run("histogram", async_exchange=True,
                                   oracle=True, **kw),
        "argmax": dryrun_fedgbf.run("argmax", oracle=True, **kw),
        "sub": dryrun_fedgbf.run("histogram", hist_subtraction=True, **kw),
        "deep": dryrun_fedgbf.run("histogram", hist_subtraction=True,
                                  max_depth=5, **kw),
        "compact": dryrun_fedgbf.run("histogram", hist_subtraction=True,
                                     max_depth=5, max_active_nodes=4, **kw),
    }
    out["tracer"] = tracer
    return out


def test_runs_reconcile_and_match_local(runs):
    for name in ("histogram", "async", "argmax", "sub", "deep", "compact"):
        r = runs[name]
        assert set(r["wire_delta"].values()) == {0}, name
        assert r["n"] == N and r["parties"] == PARTIES
        assert r["data_shards"] == SHARDS
        assert r["exchange_bytes"] + r["wire_bytes_by_phase"][
            "grad_broadcast"] == r["wire_bytes"]
        assert r["histogram_launches"] == 0     # CPU: the plain version
        assert min(r["compute_s"], r["memory_s"], r["collective_s"]) > 0
    for name in ("histogram", "async", "argmax"):
        assert runs[name]["leaf_max_abs_diff_vs_local"] is not None
    # one span a run
    assert len(runs["tracer"].spans) == 6


def test_async_over_sync_is_one(runs):
    assert (runs["async"]["wire_bytes_by_phase"]
            == runs["histogram"]["wire_bytes_by_phase"])
    assert runs["async"]["exchange_bytes"] / \
        runs["histogram"]["exchange_bytes"] == 1.0


def test_cuts_equal_jax_wire_model(runs):
    assert runs["histogram"]["exchange_bytes"] == jax_exchange_bytes(False, 3)
    assert runs["sub"]["exchange_bytes"] == jax_exchange_bytes(True, 3)
    assert runs["deep"]["exchange_bytes"] == jax_exchange_bytes(True, 5)
    assert runs["compact"]["exchange_bytes"] == jax_exchange_bytes(True, 5, 4)
    sub_cut = runs["histogram"]["exchange_bytes"] / runs["sub"][
        "exchange_bytes"]
    assert sub_cut == jax_exchange_bytes(False, 3) / jax_exchange_bytes(
        True, 3) > 1
    comp_cut = runs["deep"]["exchange_bytes"] / runs["compact"][
        "exchange_bytes"]
    assert comp_cut == jax_exchange_bytes(True, 5) / jax_exchange_bytes(
        True, 5, 4) > 1


def test_trace_exports(runs, tmp_path):
    """``--trace``'s export: one span a run and its exchange-bytes
    counter, Perfetto-loadable JSON."""
    import json

    from repro_torch.obs import perfetto

    path = tmp_path / "trace.json"
    n_events = perfetto.export_chrome_trace(str(path), runs["tracer"],
                                            metadata={"entry": "test"})
    events = json.loads(path.read_text())["traceEvents"]
    assert n_events == len(events) >= 12
    names = {e["name"] for e in events}
    assert {"round[fedgbf__forest_round__4x16__histogram]",
            "dryrun_exchange_bytes"} <= names
