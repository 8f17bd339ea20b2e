"""Bytes all parties put on the wire over the rounds: each job's
``MessageMeter.phase_totals()``, a per-passive phase times the passive
parties, summed over the window's jobs."""


def read(ctx):
    f = ctx["facts"]
    if f.get("wire_bytes") is None or not f.get("rounds"):
        return None
    return f["wire_bytes"] / f["rounds"]
