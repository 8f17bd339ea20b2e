"""Serving metrics: log-bucketed histograms, counters, Prometheus text
exposition (DESIGN.md §12).

A copy of the JAX package's ``repro/obs/metrics.py``:
the port imports no module of that package, so it keeps its own.

The serving path scores unbounded request streams, so nothing here may grow
with the stream: ``LogBucketHistogram`` stores a FIXED array of bucket
counts (no raw samples), and quantiles are derived from the buckets — the
estimate lands on the geometric midpoint of the covering bucket, so the
relative error is bounded by half the bucket growth factor (~4.5% at the
default 2**(1/8) growth), independent of stream length.

``MetricsRegistry.render()`` writes the Prometheus text exposition format
(the de-facto scrape payload); ``serve_metrics_http`` serves it over a
localhost HTTP endpoint (``serve_fedgbf --metrics-port``), and
``serve_fedgbf --metrics-out`` still dumps it to a file.

Instruments take an optional ``labels`` dict, rendering standard
``name{k="v"}`` series; several instruments may share a family name with
distinct label sets (the per-batch-size serving latency ladder), and HELP /
TYPE headers are emitted once per family.
"""

from __future__ import annotations

import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _label_str(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v

    def render(self) -> list:
        return [f"{self.name}{_label_str(self.labels)} {_fmt(self.value)}"]


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def render(self) -> list:
        return [f"{self.name}{_label_str(self.labels)} {_fmt(self.value)}"]


class LogBucketHistogram:
    """Fixed-size log-bucketed histogram (bounded memory for any stream).

    Bucket upper edges grow geometrically from ``lo`` by ``growth`` up to
    ``hi``, plus one overflow bucket; values below ``lo`` land in the first
    bucket.  ``quantile(q)`` walks the cumulative counts and returns the
    geometric midpoint of the covering bucket — error ≤ (growth - 1) / 2
    relative, by construction, with no raw-sample storage.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", lo: float = 1e-5,
                 hi: float = 60.0, growth: float = 2 ** 0.125,
                 labels: dict | None = None) -> None:
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError("need 0 < lo < hi and growth > 1")
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        self.growth = growth
        n = int(math.ceil(math.log(hi / lo) / math.log(growth))) + 1
        #: upper bucket edges, seconds; the implicit last bucket is +Inf
        self.bounds = lo * growth ** np.arange(n)
        self.counts = np.zeros(n + 1, np.int64)
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[np.searchsorted(self.bounds, v)] += 1
        self.sum += v

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def quantile(self, q: float) -> float:
        """q-quantile estimate from bucket counts (NaN when empty)."""
        total = self.count
        if total == 0:
            return float("nan")
        rank = max(1, int(math.ceil(q * total)))
        idx = int(np.searchsorted(np.cumsum(self.counts), rank))
        if idx >= len(self.bounds):  # overflow bucket: report the hi edge
            return float(self.bounds[-1])
        upper = self.bounds[idx]
        return float(upper / math.sqrt(self.growth))  # geometric midpoint

    def render(self) -> list:
        """Prometheus histogram series: cumulative ``_bucket`` lines for
        occupied buckets (+ the mandatory +Inf), ``_sum``, ``_count``."""
        lab = _label_str(self.labels)
        lines, cum = [], 0
        for i, c in enumerate(self.counts[:-1]):
            if c:
                cum += int(c)
                bucket = dict(self.labels, le=_fmt(self.bounds[i]))
                lines.append(f"{self.name}_bucket{_label_str(bucket)} {cum}")
        inf = dict(self.labels, le="+Inf")
        lines.append(f"{self.name}_bucket{_label_str(inf)} {self.count}")
        lines.append(f"{self.name}_sum{lab} {_fmt(self.sum)}")
        lines.append(f"{self.name}_count{lab} {self.count}")
        return lines


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integral values without the '.0'."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class MetricsRegistry:
    """Orders instruments and renders the text exposition.

    Uniqueness is per SERIES — family name + label set — so a family may
    carry many labeled instruments (e.g. one latency histogram per batch
    rung); HELP/TYPE render once per family, on first appearance.
    """

    def __init__(self) -> None:
        self._metrics: list = []
        self._names: set = set()

    def _register(self, metric):
        key = metric.name + _label_str(metric.labels)
        if key in self._names:
            raise ValueError(f"duplicate metric {key!r}")
        self._names.add(key)
        self._metrics.append(metric)
        return metric

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._register(Counter(name, help, labels=labels))

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._register(Gauge(name, help, labels=labels))

    def histogram(self, name: str, help: str = "", **kw) -> LogBucketHistogram:
        return self._register(LogBucketHistogram(name, help, **kw))

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        out, seen = [], set()
        for m in self._metrics:
            if m.name not in seen:
                seen.add(m.name)
                if m.help:
                    out.append(f"# HELP {m.name} {m.help}")
                out.append(f"# TYPE {m.name} {m.kind}")
            out.extend(m.render())
        return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# HTTP scrape endpoint (DESIGN.md §14): the registry's exposition, served
# ---------------------------------------------------------------------------
class MetricsHTTPServer:
    """Localhost Prometheus scrape endpoint over a live registry.

    A daemon-threaded ``ThreadingHTTPServer`` whose GET handler renders the
    registry *at scrape time* — no snapshotting, the instruments mutate as
    the serving loop runs and the scraper always sees the current counts.
    ``port=0`` binds an ephemeral port (tests); ``.port`` reports the bound
    one.  ``close()`` shuts the listener down.
    """

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1") -> None:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                body = outer.registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", outer.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes stay off stderr
                pass

        self.registry = registry
        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def serve_metrics_http(registry: MetricsRegistry, port: int = 0,
                       host: str = "127.0.0.1") -> MetricsHTTPServer:
    """Start a scrape endpoint for ``registry``; returns the server handle."""
    return MetricsHTTPServer(registry, port=port, host=host)
