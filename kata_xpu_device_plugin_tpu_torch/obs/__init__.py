"""Telemetry of the port (counterpart of ``kata_xpu_device_plugin_tpu/obs``):
spans, metrics, events, the flight recorder, the profiler hook, the
serving watchdog and the device ledger, with the JAX package's names,
event kinds and fields, so the device plugin's readers take either
package's stream.

- :mod:`.trace`     — spans that fence on CUDA tensors before their end
  stamp (an event on the producing stream, never a device-wide
  synchronize), detached spans for overlapped rounds, and
  :class:`DeviceFence`, the overlapped round's copy to the host;
- :mod:`.metrics`   — an idempotent counter/gauge/histogram factory with
  the Prometheus text exposition and ``/metrics`` endpoint, in plain
  Python (no ``prometheus_client``), and :class:`Rolling`;
- :mod:`.events`    — the JSONL event sink (``KATATPU_OBS=1`` and
  ``KATATPU_OBS_FILE``, the names the daemon injects) and its readers;
- :mod:`.flight`    — the always-armed ring of recent events, dumped on a
  terminal event (``KATATPU_FLIGHT*``);
- :mod:`.profiler`  — a ``torch.profiler`` window over N steps;
- :mod:`.watchdog`  — the SLO-burn watchdog over serving heartbeats;
- :mod:`.devledger` — the per-server utilization (analytic FLOPs per
  dispatch signature) and device-memory ledger.

Importing this package loads ``torch`` through :mod:`.trace` only;
``torch.profiler`` loads when a window opens.
"""
from __future__ import annotations

from . import devledger, watchdog
from .devledger import DeviceLedger
from .events import (
    EventSink,
    configure_from_env,
    default_sink,
    emit,
    enabled,
    read_events,
    set_default_sink,
    summarize_phases,
    tail_events,
)
from .flight import FlightRecorder, set_default_recorder
from .metrics import (
    DEFAULT_REGISTRY,
    MetricsRegistry,
    Rolling,
    counter,
    gauge,
    histogram,
    serve,
)
from .profiler import ProfilerHook, profiler_from_env
from .trace import (
    DeviceFence,
    Span,
    current_span_id,
    current_trace_id,
    new_trace,
    span,
    start_span,
    timer,
    traced,
)
from .watchdog import ALERT_KINDS, SLOBurnWatchdog, WatchdogConfig

__all__ = [
    "DeviceLedger",
    "EventSink",
    "configure_from_env",
    "default_sink",
    "emit",
    "enabled",
    "read_events",
    "set_default_sink",
    "summarize_phases",
    "tail_events",
    "FlightRecorder",
    "set_default_recorder",
    "DEFAULT_REGISTRY",
    "MetricsRegistry",
    "Rolling",
    "counter",
    "gauge",
    "histogram",
    "serve",
    "ProfilerHook",
    "profiler_from_env",
    "ALERT_KINDS",
    "SLOBurnWatchdog",
    "WatchdogConfig",
    "DeviceFence",
    "Span",
    "current_span_id",
    "current_trace_id",
    "new_trace",
    "span",
    "start_span",
    "timer",
    "traced",
    "devledger",
    "watchdog",
]
