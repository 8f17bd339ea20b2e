"""Structured per-round training log (``train_fedgbf --log-json``).

A copy of the JAX package's ``repro/obs/log.py``:
the port imports no module of that package, so it keeps its own.

One JSON object per round — schedule, wall time, gated metrics, in-graph
liveness telemetry, and the ledger's per-round wire bytes — replacing the
ad-hoc ``[round NNN] ...`` prints with something machines consume
(``benchmarks/obs_bench.py`` parses these lines back).

The scan engine has no per-round host sync (DESIGN.md §4), so the lines are
rendered AFTER training from the fetched history: this is a structured
record of the run, not a live stream.
"""

from __future__ import annotations

import json


def round_records(history, per_round_bytes=None, faults=None) -> list:
    """One dict per round from a ``TrainHistory`` (+ optional ledger rows).

    ``per_round_bytes`` is ``ProtocolLedger.per_round_measured()`` — the
    same rows the trace exporter uses, so log, trace and ledger agree
    byte-for-byte.  ``faults`` is an optional list (one dict per executed
    round) of fault-runtime counters — ``faults_injected`` / ``retries`` /
    ``degraded_parties`` (DESIGN.md §13) — attached verbatim under
    ``"faults"``.  Round numbers are ABSOLUTE: a resumed segment starting at
    ``history.start_round`` logs rounds ``start_round + 1 ...``, so stitched
    logs from a killed-and-resumed run line up with an uninterrupted one.
    """
    base = int(getattr(history, "start_round", 0) or 0)
    eval_at = {m: i for i, m in enumerate(history.rounds)}
    tele = history.telemetry or {}
    recs = []
    for i in range(len(history.n_trees)):
        rec = {
            "event": "round",
            "round": base + i + 1,
            "n_trees": int(history.n_trees[i]),
            "rho_id": round(float(history.rho_id[i]), 6),
            "wall_s": (round(float(history.wall_time_s[i]), 6)
                       if i < len(history.wall_time_s) else None),
            "metrics": None,
            "valid": None,
        }
        j = eval_at.get(base + i + 1)
        if j is not None:
            rec["metrics"] = {k: float(v) for k, v in history.train[j].items()}
            if j < len(history.valid):
                rec["valid"] = {k: float(v)
                                for k, v in history.valid[j].items()}
        if tele.get("split_nodes_per_level") is not None:
            per_level = tele["split_nodes_per_level"]
            if i < len(per_level):
                rec["liveness"] = {
                    "split_nodes_per_level": [int(v) for v in per_level[i]],
                    "sampled_entries": int(tele["sampled_entries"][i]),
                }
        if per_round_bytes is not None and i < len(per_round_bytes):
            rec["bytes"] = {k: int(v) for k, v in per_round_bytes[i].items()
                            if v}
        if faults is not None and i < len(faults) and faults[i]:
            rec["faults"] = faults[i]
        recs.append(rec)
    return recs


def render_round_lines(history, per_round_bytes=None, faults=None) -> list:
    """The ``--log-json`` lines: compact one-object-per-line JSON."""
    return [json.dumps(r, separators=(",", ":"))
            for r in round_records(history, per_round_bytes, faults)]


def parse_round_log(text: str) -> list:
    """Recover the round records from mixed driver output: non-JSON lines
    (backend banners, ledger prints) are skipped, only ``event == "round"``
    objects survive."""
    recs = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and obj.get("event") == "round":
            recs.append(obj)
    return recs
