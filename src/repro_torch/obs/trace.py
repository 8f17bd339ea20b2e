"""Host-side span tracing with a zero-overhead disabled path (DESIGN.md §12).

A copy of the JAX package's ``repro/obs/trace.py`` (the port imports no
module of that package, so it keeps its own), with ``use`` and the
profiler marks below added.

A ``Tracer`` records closed ``Span`` intervals (absolute ``perf_counter``
seconds, so every producer in the process shares one clock) plus counter
samples.  Spans come in two flavours:

* live ``with tracer.span(...)`` context managers for host work that is
  being timed as it happens (binning, the scan-program call, checkpoint
  I/O);
* derived ``tracer.add_span(name, t0, t1, ...)`` intervals reconstructed
  after the fact from other clocks on the same timebase — the scan engine's
  in-program segment ticks, per-round slices of ``TrainHistory``, the
  ledger's per-round wire bytes.

``track`` groups spans into named rows ("threads" in the Chrome trace
model): the exporter assigns one tid per track, so host spans, round spans
and per-phase wire spans land on separate swim-lanes in Perfetto.

The disabled path is ``NULL_TRACER``: ``span()`` returns one shared no-op
context-manager singleton (no per-call allocation — asserted by
tests/test_obs.py), ``add_span``/``counter`` are no-ops, so instrumented
code pays a method call and nothing else when tracing is off.

``set_global_tracer`` / ``global_tracer`` is the process-wide seam for code
that cannot thread a tracer argument (checkpoint I/O, library internals):
default ``NULL_TRACER``, flipped by ``train_fedgbf --trace`` and friends;
``use(tracer)`` installs one for a block (``train_fedgbf`` runs its body
under the caller's tracer, so the tree build, the federation and the kernel
wrappers report to it).

On the profiler's clock: while a ``torch.profiler`` runs, every live span
of either tracer also opens ``record_function("span:" + name)``, so the
program's phases appear in the profiler's trace beside the ops and kernels
they issue, and an idle gap of the device can be named by the phase open on
the host.  The ``span:`` prefix keeps the marks apart from torch's own ops
(their device-side annotations are not device work).  The test is one
module attribute read (``torch.autograd.profiler._is_profiler_enabled``);
with no profiler running the disabled path stays allocation-free.
"""

from __future__ import annotations

import contextlib
import time

from torch.autograd import profiler as _profiler

#: the namespace of the program's marks in a profiler's trace
SPAN_PREFIX = "span:"


class Span:
    """One closed interval: [t0, t1] absolute ``perf_counter`` seconds."""

    __slots__ = ("name", "cat", "t0", "t1", "track", "args", "depth")

    def __init__(self, name, cat="host", t0=0.0, t1=0.0, track="host",
                 args=None, depth=0):
        self.name = name
        self.cat = cat
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.track = track
        self.args = args
        self.depth = depth

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"dur={self.duration_s * 1e3:.3f}ms, track={self.track!r})")


class _ActiveSpan:
    """Live span context manager: times the block, appends on exit, and
    marks it in the profiler's trace while one runs."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_depth",
                 "_mark")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._mark = None
        if _profiler._is_profiler_enabled:
            self._mark = _profiler.record_function(SPAN_PREFIX + self._name)
            self._mark.__enter__()
        self._depth = self._tracer._depth
        self._tracer._depth = self._depth + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._mark is not None:
            self._mark.__exit__(exc_type, exc, tb)
        self._tracer._depth = self._depth
        self._tracer.spans.append(
            Span(self._name, self._cat, self._t0, t1, "host", self._args,
                 self._depth)
        )
        return False


class _NullSpan:
    """Shared no-op context manager — the whole disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call is a no-op, ``span()`` allocates nothing
    (returns the module-level ``_NULL_SPAN`` singleton) unless a profiler
    runs, when it returns the span's mark in the profiler's trace."""

    enabled = False

    def span(self, name, cat="host", args=None):
        if _profiler._is_profiler_enabled:
            return _profiler.record_function(SPAN_PREFIX + name)
        return _NULL_SPAN

    def add_span(self, name, t0, t1, cat="host", track="host", args=None):
        pass

    def counter(self, name, values, ts=None):
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer: ``spans`` (list of ``Span``) and ``counters``
    (list of ``(name, ts, values_dict)`` samples)."""

    enabled = True

    def __init__(self) -> None:
        self.spans: list = []
        self.counters: list = []
        self._depth = 0  # live-span nesting depth (host track only)

    def span(self, name, cat="host", args=None):
        """Context manager timing the enclosed block on the host track."""
        return _ActiveSpan(self, name, cat, args)

    def add_span(self, name, t0, t1, cat="host", track="host", args=None):
        """Append a derived interval (same ``perf_counter`` timebase)."""
        self.spans.append(Span(name, cat, t0, t1, track, args))

    def counter(self, name, values, ts=None):
        """Record one counter sample: ``values`` is a {series: number} dict."""
        self.counters.append(
            (name, time.perf_counter() if ts is None else float(ts),
             dict(values))
        )


_GLOBAL_TRACER = NULL_TRACER


def set_global_tracer(tracer) -> None:
    """Install the process-wide tracer (``NULL_TRACER`` to disable)."""
    global _GLOBAL_TRACER
    _GLOBAL_TRACER = tracer if tracer is not None else NULL_TRACER


def global_tracer():
    """The process-wide tracer; ``NULL_TRACER`` unless a launcher set one."""
    return _GLOBAL_TRACER


@contextlib.contextmanager
def use(tracer):
    """Install ``tracer`` as the process-wide tracer for the block, and
    restore the previous one on leaving it (also on an exception)."""
    previous = _GLOBAL_TRACER
    set_global_tracer(tracer)
    try:
        yield tracer
    finally:
        set_global_tracer(previous)
