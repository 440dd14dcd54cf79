"""Metrics of the port: an idempotent counter/gauge/histogram factory, the
Prometheus text exposition and its ``/metrics`` endpoint, and
:class:`Rolling` (counterpart of ``kata_xpu_device_plugin_tpu/obs/metrics.py``).

The JAX package builds on ``prometheus_client``; a machine that runs the
port need not have it, so this module is plain Python with the same
surface:

- :class:`MetricsRegistry` creates collectors by name, type and label
  names; asking again for the same metric returns the same collector (a
  reload or a second server never double-registers), and asking for it
  under another type or other labels raises;
- a collector with labels hands out one child per label values
  (``.labels(server="server0")``); a child counts (``inc``), holds a value
  (``set``, or ``set_function`` for a value read at scrape time) or
  observes into cumulative buckets (``observe``). A collector without
  labels does the same itself;
- :meth:`MetricsRegistry.exposition` writes the text format 0.0.4 that
  Prometheus scrapes, as ``prometheus_client`` writes it: a counter ``x``
  is the family ``x_total``, a histogram its ``_bucket`` series (``le``
  bounds, ``+Inf`` last), ``_count`` and ``_sum``, and both carry a
  ``_created`` gauge (the child's creation time). :func:`serve` answers
  ``GET /metrics`` with it on a daemon thread of ``http.server``.

Names, label names and buckets are the JAX package's: one dashboard reads
either server.

:class:`Rolling` is the host-side summary (count/sum/min/max and a bounded
reservoir for quantiles) behind the ``stats()`` latency dicts.
"""
from __future__ import annotations

import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

# Latency buckets (the JAX package's): sub-ms device steps through
# multi-second compiles.
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v: float) -> str:
    """A sample value in the exposition's spelling (Go's float format)."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    f = float(v)
    return repr(int(f)) + ".0" if f.is_integer() and abs(f) < 1e16 else repr(f)


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _labels_text(pairs) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(str(v))}"' for k, v in pairs) + "}"


class _Child:
    """One time series (or one histogram) of a collector."""

    __slots__ = ("_lock", "_value", "_fn", "_buckets", "_counts", "_sum",
                 "created")

    def __init__(self, buckets: Optional[tuple] = None):
        self.created = time.time()
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._buckets = buckets
        self._counts = [0] * len(buckets) if buckets else None
        self._sum = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._fn = None

    def set_function(self, fn: Callable[[], float]) -> None:
        """Read the value from ``fn()`` at every scrape."""
        with self._lock:
            self._fn = fn

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            for i, bound in enumerate(self._buckets):
                if value <= bound:
                    self._counts[i] += 1
                    break

    def get(self) -> float:
        fn = self._fn
        if fn is not None:
            return float(fn())
        return self._value

    def _histogram(self) -> tuple[list, float]:
        with self._lock:
            counts, total = list(self._counts), self._sum
        acc, cum = 0, []
        for c in counts:
            acc += c
            cum.append(acc)
        return cum, total


class _Collector:
    """A named metric with its label names and its children."""

    def __init__(self, kind: str, name: str, doc: str, labelnames: tuple,
                 buckets: Optional[Sequence[float]] = None):
        if kind == "counter" and name.endswith("_total"):
            name = name[: -len("_total")]  # exposed as <stem>_total
        self.kind, self.name, self.doc = kind, name, doc
        self._labelnames = tuple(labelnames)
        self._bucket_bounds = None
        if kind == "histogram":
            bounds = sorted(float(b) for b in buckets)
            if not bounds or bounds[-1] != math.inf:
                bounds.append(math.inf)
            self._bucket_bounds = tuple(bounds)
        self._lock = threading.Lock()
        self._children: dict[tuple, _Child] = {}
        if not self._labelnames:
            self._children[()] = _Child(self._bucket_bounds)

    def labels(self, *values, **kw) -> _Child:
        if kw:
            if values:
                raise ValueError("pass label values by position or by name")
            values = tuple(kw[n] for n in self._labelnames)
            if len(kw) != len(self._labelnames):
                raise ValueError(f"labels {sorted(kw)} != {self._labelnames}")
        if len(values) != len(self._labelnames) or not self._labelnames:
            raise ValueError(f"{self.name} takes labels {self._labelnames}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self._bucket_bounds)
            return child

    def _only(self) -> _Child:
        if self._labelnames:
            raise ValueError(f"{self.name} has labels {self._labelnames}: "
                             "use .labels(...)")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._only().set_function(fn)

    def observe(self, value: float) -> None:
        self._only().observe(value)

    def exposition(self) -> list[str]:
        doc = self.doc.replace("\n", " ")
        family = self.name + ("_total" if self.kind == "counter" else "")
        lines = [f"# HELP {family} {doc}", f"# TYPE {family} {self.kind}"]
        with self._lock:
            children = sorted(self._children.items())
        created = []
        for values, child in children:
            pairs = list(zip(self._labelnames, values))
            if self.kind == "histogram":
                cum, total = child._histogram()
                for bound, n in zip(self._bucket_bounds, cum):
                    le = _labels_text(pairs + [("le", _fmt(bound))])
                    lines.append(f"{self.name}_bucket{le} {_fmt(n)}")
                lines.append(f"{self.name}_count{_labels_text(pairs)} "
                             f"{_fmt(cum[-1])}")
                lines.append(f"{self.name}_sum{_labels_text(pairs)} {_fmt(total)}")
            else:
                try:
                    value = child.get()
                except Exception:
                    value = math.nan  # a scrape-time reader must not break it
                lines.append(f"{family}{_labels_text(pairs)} {_fmt(value)}")
            if self.kind != "gauge":
                created.append(f"{self.name}_created{_labels_text(pairs)} "
                               f"{_fmt(child.created)}")
        if created:
            lines += [f"# HELP {self.name}_created {doc}",
                      f"# TYPE {self.name}_created gauge", *created]
        return lines


class MetricsRegistry:
    """Idempotent counter/gauge/histogram factory, and the collectors one
    exposition covers.

    >>> reg = MetricsRegistry()
    >>> c = reg.counter("requests_total", "Requests", ["outcome"])
    >>> c is reg.counter("requests_total", "Requests", ["outcome"])
    True
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._collectors: dict[str, _Collector] = {}

    def counter(self, name: str, doc: str, labels: Sequence[str] = ()):
        return self._get("counter", name, doc, labels)

    def gauge(self, name: str, doc: str, labels: Sequence[str] = ()):
        return self._get("gauge", name, doc, labels)

    def histogram(self, name: str, doc: str, labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS):
        return self._get("histogram", name, doc, labels, buckets)

    def _get(self, kind: str, name: str, doc: str, labels, buckets=None):
        new = _Collector(kind, name, doc, tuple(labels), buckets)
        with self._lock:
            made = self._collectors.setdefault(new.name, new)
        if made.kind != kind or made._labelnames != tuple(labels):
            raise ValueError(
                f"metric {name!r} already exists as {made.kind} with labels "
                f"{made._labelnames}, requested {kind} with {tuple(labels)}")
        return made

    def exposition(self) -> str:
        with self._lock:
            collectors = sorted(self._collectors.values(), key=lambda c: c.name)
        lines: list[str] = []
        for c in collectors:
            lines += c.exposition()
        return "\n".join(lines) + "\n"


# The process default: every instrumented path that does not inject its own.
DEFAULT_REGISTRY = MetricsRegistry()


def counter(name: str, doc: str, labels: Sequence[str] = ()):
    return DEFAULT_REGISTRY.counter(name, doc, labels)


def gauge(name: str, doc: str, labels: Sequence[str] = ()):
    return DEFAULT_REGISTRY.gauge(name, doc, labels)


def histogram(name: str, doc: str, labels: Sequence[str] = (),
              buckets: Sequence[float] = LATENCY_BUCKETS):
    return DEFAULT_REGISTRY.histogram(name, doc, labels, buckets)


_served: dict[int, ThreadingHTTPServer] = {}
_served_lock = threading.Lock()


def _handler(reg: MetricsRegistry) -> type:
    """The request handler of :func:`serve`: ``GET /metrics`` (or ``/``)
    answers with ``reg``'s exposition, anything else 404."""

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server's spelling
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = reg.exposition().encode()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes are not news
            pass

    return _Handler


def serve(port: int, registry: Optional[MetricsRegistry] = None,
          addr: str = "") -> Optional[int]:
    """Start the ``/metrics`` endpoint on ``port`` (0 disables) on a daemon
    thread; once a process for a given port (a second call is a no-op).
    Returns the port."""
    if not port:
        return None
    with _served_lock:
        if port not in _served:
            httpd = ThreadingHTTPServer(
                (addr, port), _handler(registry or DEFAULT_REGISTRY))
            httpd.daemon_threads = True
            threading.Thread(target=httpd.serve_forever, daemon=True,
                             name=f"metrics:{port}").start()
            _served[port] = httpd
    return port


class Rolling:
    """Host-side summary: count/sum/min/max plus a bounded reservoir of the
    most recent values for p50/p95/p99. Thread-safe; ``summary()`` returns
    plain floats."""

    def __init__(self, keep: int = 512):
        self._lock = threading.Lock()
        self._keep = keep
        self._recent: list[float] = []
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            self._recent.append(value)
            if len(self._recent) > self._keep:
                del self._recent[: len(self._recent) - self._keep]

    def _quantile(self, q: float) -> float:
        vals = sorted(self._recent)
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))
        return vals[idx]

    def summary(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0}
            return {
                "count": self.count,
                "mean": round(self.total / self.count, 6),
                "min": round(self.min or 0.0, 6),
                "max": round(self.max or 0.0, 6),
                "p50": round(self._quantile(0.50), 6),
                "p95": round(self._quantile(0.95), 6),
                "p99": round(self._quantile(0.99), 6),
            }
