"""Chrome-trace/Perfetto JSON export (DESIGN.md §12).

A copy of the JAX package's ``repro/obs/perfetto.py``:
the port imports no module of that package, so it keeps its own.

Everything a training run knows about time and bytes merges into ONE
timeline in the Chrome trace event format (Perfetto opens it directly):

* live host spans from a ``trace.Tracer`` → ``"X"`` complete events, one
  tid per span ``track`` (named via ``thread_name`` metadata events);
* ``TrainHistory`` rounds → derived per-round spans on the ``rounds``
  track, positioned from the scan engine's in-program segment ticks
  (``history.segments`` carries absolute host-clock [t0, t1] per segment;
  rounds inside a segment slice it uniformly — the engine's granularity
  limit, see ``TrainHistory.wall_time_s``);
* the ledger's per-round wire bytes (``ProtocolLedger.per_round_measured``)
  → per-phase spans on ``wire/<phase>`` tracks whose ``args.bytes`` sum
  EXACTLY to ``ProtocolLedger.breakdown()["measured"]`` — both sides are
  the same ``protocol.per_round_cost`` arithmetic, so the trace is a view
  of the ledger, not a second accounting;
* in-graph telemetry (live split-node counts) → ``"C"`` counter events.

Timestamps are absolute ``perf_counter`` microseconds; Perfetto normalizes
to the trace minimum on load.
"""

from __future__ import annotations

import json
import os


def to_chrome_trace(tracer, metadata=None) -> dict:
    """Render a ``trace.Tracer`` to a Chrome trace event dict."""
    events: list = []
    tids: dict = {}

    def tid_of(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids)
            events.append({
                "ph": "M", "name": "thread_name", "pid": 0,
                "tid": tids[track], "args": {"name": track},
            })
        return tids[track]

    tid_of("host")  # keep the live-span track first in the UI
    for s in tracer.spans:
        events.append({
            "ph": "X", "name": s.name, "cat": s.cat,
            "ts": s.t0 * 1e6, "dur": max(0.0, s.t1 - s.t0) * 1e6,
            "pid": 0, "tid": tid_of(s.track), "args": s.args or {},
        })
    for name, ts, values in tracer.counters:
        events.append({
            "ph": "C", "name": name, "ts": ts * 1e6, "pid": 0,
            "args": values,
        })
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if metadata:
        doc["metadata"] = dict(metadata)
    return doc


def export_chrome_trace(path: str, tracer, metadata=None) -> int:
    """Write the Perfetto-loadable JSON; returns the event count."""
    doc = to_chrome_trace(tracer, metadata)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


def round_intervals(history) -> list:
    """Absolute host-clock [t0, t1] per round from ``history.segments``.

    Returns ``[(round_index_0based, t0, t1), ...]`` sorted by round.  Rounds
    inside a segment share its measured wall uniformly (the scan engine's
    per-round granularity limit); the loop engine records one single-round
    segment per round, so its intervals are exact.  Empty when the history
    carries no segment anchors (e.g. hand-built histories).
    """
    out = []
    for seg in history.segments:
        rounds = max(1, int(seg["rounds"]))
        per = (seg["t1"] - seg["t0"]) / rounds
        for r in range(rounds):
            out.append((int(seg["first_round"]) + r,
                        seg["t0"] + r * per, seg["t0"] + (r + 1) * per))
    out.sort()
    return out


def add_training_timeline(tracer, history, per_round_bytes=None,
                          faults=None) -> None:
    """Merge a ``TrainHistory`` (and optionally the ledger's per-round wire
    bytes) into ``tracer`` as derived spans + counters.

    Per-round spans land on the ``rounds`` track carrying schedule, metric
    and liveness args; each wire phase gets its own ``wire/<phase>`` track
    whose span ``args.bytes`` are exactly ``per_round_bytes`` (i.e. the
    ledger's own ``protocol.per_round_cost`` rows).  ``faults`` (optional,
    one dict per executed round — DESIGN.md §13) adds a ``faults`` track:
    one span per round that actually saw injected faults, retries, or party
    degradation, so chaos shows up as a first-class timeline lane.

    Segment anchors carry ABSOLUTE ``first_round``; per-executed-round
    lists (``n_trees`` etc.) are indexed relative to ``history.start_round``
    so resumed segments land at their true round numbers.
    """
    tele = history.telemetry or {}
    per_level = tele.get("split_nodes_per_level")
    eval_at = {m: i for i, m in enumerate(history.rounds)}
    base = int(getattr(history, "start_round", 0) or 0)
    cum: dict = {}
    for i, t0, t1 in round_intervals(history):
        k = i - base  # executed-round index into the history lists
        args = {
            "n_trees": int(history.n_trees[k]),
            "rho_id": round(float(history.rho_id[k]), 6),
        }
        if (i + 1) in eval_at:
            args["metrics"] = history.train[eval_at[i + 1]]
        if per_level is not None and k < len(per_level):
            args["split_nodes_per_level"] = per_level[k]
            tracer.counter("live_split_nodes",
                           {"nodes": int(sum(per_level[k]))}, ts=t1)
        tracer.add_span(f"round {i + 1}", t0, t1, cat="round",
                        track="rounds", args=args)
        if faults is not None and k < len(faults) and faults[k]:
            fa = faults[k]
            if (fa.get("faults_injected") or fa.get("retries")
                    or fa.get("degraded_parties")):
                tracer.add_span(f"faults r{i + 1}", t0, t1, cat="fault",
                                track="faults", args=dict(fa))
        if per_round_bytes is not None and k < len(per_round_bytes):
            for phase, nbytes in per_round_bytes[k].items():
                if not nbytes:
                    continue
                tracer.add_span(phase, t0, t1, cat="wire",
                                track=f"wire/{phase}",
                                args={"bytes": int(nbytes)})
                cum[phase] = cum.get(phase, 0) + int(nbytes)
                tracer.counter(f"wire_bytes/{phase}",
                               {"bytes": cum[phase]}, ts=t1)


def wire_span_phase_totals(tracer) -> dict:
    """Sum the exported wire-span bytes per phase — the quantity the
    acceptance check reconciles against ``ProtocolLedger.breakdown()``."""
    out: dict = {}
    for s in tracer.spans:
        if s.cat == "wire" and s.args:
            out[s.name] = out.get(s.name, 0) + int(s.args.get("bytes", 0))
    return out
