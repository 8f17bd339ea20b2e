"""Spans of the harness and of the program, and the reduction of a
``torch.profiler`` trace to the device's busy time, the device time by
kernel and the idle gaps by what the host was doing.

``HostSpans`` is the tracer the harness hands the program
(``train_fedgbf(tracer=...)``) and wraps around its own calls.  It keeps
its spans in memory on the host clock and, while a profiler runs, also
marks each span in the trace (``record_function``), so that an idle gap
of the device can be named by the span open on the host at the time.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

SPAN_PREFIX = "span:"
WINDOW = SPAN_PREFIX + "window"


@dataclass
class Span:
    name: str
    t0: float
    t1: float


class HostSpans:
    """A tracer with the port's ``span`` / ``add_span`` / ``counter``
    methods: spans in memory, marked in the profiler's trace while
    ``profiling`` is set."""

    enabled = True

    def __init__(self) -> None:
        self.spans: list = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name, cat="host", args=None):
        t0 = time.perf_counter()
        if self.profiling:
            from torch.profiler import record_function

            with record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.spans.append(Span(name, t0, time.perf_counter()))

    def add_span(self, name, t0, t1, cat="host", track="host", args=None):
        self.spans.append(Span(name, t0, t1))

    def counter(self, name, values, ts=None):
        pass


@dataclass
class TraceReading:
    """What a traced window showed, in seconds."""

    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)     # device time by name
    idle_by_host: dict = field(default_factory=dict)  # idle time by label
    device_events: int = 0

    def kernel_time(self, names) -> float:
        """Device time of every kernel whose name contains one of
        ``names``."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def union(intervals: list) -> list:
    """Merged, sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    """The complement of merged ``busy`` intervals inside ``[lo, hi]``."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def innermost(intervals: list, queries: list) -> list:
    """For each query time, the index of the innermost of the nested
    ``intervals`` ((start, end) pairs) that covers it, or -1."""
    order = sorted(range(len(intervals)),
                   key=lambda i: (intervals[i][0], -intervals[i][1]))
    answer = [-1] * len(queries)
    stack: list = []
    j = 0
    for q in sorted(range(len(queries)), key=lambda i: queries[i]):
        t = queries[q]
        while j < len(order) and intervals[order[j]][0] <= t:
            i = order[j]
            while stack and intervals[stack[-1]][1] < intervals[i][0]:
                stack.pop()
            stack.append(i)
            j += 1
        while stack and intervals[stack[-1]][1] < t:
            stack.pop()
        answer[q] = stack[-1] if stack else -1
    return answer


def reduce_events(window: tuple, device: list, spans: list,
                  host_ops: list) -> TraceReading:
    """The reading of one traced window (all times in microseconds on the
    profiler's clock): ``window`` (start, end); ``device`` (name, start,
    end) activities; ``spans`` and ``host_ops`` (name, start, end) on the
    host thread that drove the window."""
    lo, hi = window
    kernel_s: dict = {}
    busy = []
    for name, a, b in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
        busy.append((a, b))
    merged = union(busy)
    busy_us = sum(b - a for a, b in merged)
    idle = gaps(merged, lo, hi)
    mids = [(a + b) / 2 for a, b in idle]
    span_of = innermost([(a, b) for _, a, b in spans], mids)
    op_of = innermost([(a, b) for _, a, b in host_ops], mids)
    idle_by_host: dict = {}
    for (a, b), si, oi in zip(idle, span_of, op_of):
        label = spans[si][0] if si >= 0 else "(no span)"
        if oi >= 0:
            label += " / " + host_ops[oi][0]
        idle_by_host[label] = idle_by_host.get(label, 0.0) + (b - a) * 1e-6
    return TraceReading(window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6,
                        kernel_s=kernel_s, idle_by_host=idle_by_host,
                        device_events=len(device))


def _round_label(name: str) -> str:
    """``round 17`` and its like to ``round N``: one label for every
    round."""
    head, _, tail = name.rpartition(" ")
    return f"{head} N" if head and tail.isdigit() else name


def profile(fn, spans: HostSpans, cuda: bool):
    """Run ``fn`` under ``torch.profiler`` (CPU, and CUDA where there is a
    card) and return ``(fn(), TraceReading)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    spans.profiling = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            with record_function(WINDOW):
                result = fn()
    finally:
        spans.profiling = False
    window = None
    device, marks, ops = [], [], []
    # the raw events: building ``prof.events()`` costs seconds a 100,000
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() * 1e-3
        b = a + e.duration_ns() * 1e-3
        if e.device_type() == DeviceType.CUDA:
            # the spans' own marks are also drawn on the device's timeline
            if not name.startswith(SPAN_PREFIX):
                device.append((name, a, b))
        elif name == WINDOW:
            window = (a, b, e.start_thread_id())
        elif name.startswith(SPAN_PREFIX):
            marks.append((e.start_thread_id(),
                          _round_label(name[len(SPAN_PREFIX):]), a, b))
        else:
            ops.append((e.start_thread_id(), name, a, b))
    if window is None:
        raise RuntimeError("the profiler's trace holds no window mark")
    lo, hi, thread = window
    reading = reduce_events(
        (lo, hi), device,
        [(n, a, b) for t, n, a, b in marks if t == thread],
        [(n, a, b) for t, n, a, b in ops if t == thread])
    return result, reading
