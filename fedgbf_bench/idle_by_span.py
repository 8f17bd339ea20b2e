"""The device's idle time by the program's phase: a traced window's
``idle_by_host`` entries (``<span>`` or ``<span> / <host op>``, each gap
named by ``tracing.reduce_events`` after the innermost span open at its
middle) summed by their span.

The program's phases are the spans of ``src/repro_torch`` that mark the
profiler's trace while one runs (``obs/trace.py``); a trace in which no
idle falls under any of them comes from a program that does not report
its phases, and reads as nothing rather than as zero.
"""

from __future__ import annotations

#: the program's phase spans
PHASES = ("job.inputs", "job.masks", "job.fetch", "round.gradients",
          "round.update", "tree.histogram", "tree.split", "tree.route",
          "tree.leaf", "kernel.histogram", "federation.exchange",
          "serve.admit", "serve.copy_in", "serve.score", "serve.copy_out")
#: spans that name no phase: the program's round, the harness's job,
#: batch call and window, and no span at all
UNNAMED = ("round N", "job", "serve_stream", "window", "(no span)")


def by_span(trace) -> dict | None:
    """``{span: idle seconds}``; None without a trace, without device
    events, or where no idle falls under a phase span."""
    if trace is None or trace.device_events == 0:
        return None
    out: dict = {}
    for label, seconds in trace.idle_by_host.items():
        span = label.split(" / ", 1)[0]
        out[span] = out.get(span, 0.0) + seconds
    if not any(span in PHASES for span in out):
        return None
    return out


def per_unit(ctx: dict, spans: tuple, unit: str, scale: float):
    """The idle seconds under ``spans`` over ``facts[unit]`` (the traced
    rounds or batches), times ``scale``."""
    idle = by_span(ctx["trace"])
    count = ctx["facts"].get(unit)
    if idle is None or not count:
        return None
    return sum(idle.get(s, 0.0) for s in spans) / count * scale


def unattributed_share(ctx: dict):
    """The share of all idle, in %, under no program span."""
    idle = by_span(ctx["trace"])
    if idle is None:
        return None
    total = sum(idle.values())
    if total <= 0:
        return None
    return 100.0 * sum(idle.get(s, 0.0) for s in UNNAMED) / total
