"""Structured logging of the host daemon (counterpart of
``kata_xpu_device_plugin_tpu/utils/log.py``): one logger tree under
``katatpu`` writing key=value text or JSON lines to stderr.

A line logged inside an open span of the port's ``obs`` carries that
span's ``trace`` and ``span`` ids, so an Allocate handler's "allocated"
line joins the span event of the same request.
"""
from __future__ import annotations

import json
import logging
import sys
import time

ROOT = "katatpu"


def _trace_context() -> dict:
    """trace/span ids of the innermost open obs span (empty at top level).
    Imported per record: this module stays importable before the obs
    package, and obs.trace itself logs nothing."""
    try:
        from ..obs import trace
    except Exception:
        return {}
    tid = trace.current_trace_id()
    if tid is None:
        return {}
    return {"trace": tid, "span": trace.current_span_id()}


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        entry.update(_trace_context())
        extra = getattr(record, "kv", None)
        if extra:
            entry.update(extra)
        return json.dumps(entry, sort_keys=False)


class _TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = (
            f"{self.formatTime(record, '%Y-%m-%dT%H:%M:%S')} "
            f"{record.levelname[0]} {record.name} {record.getMessage()}"
        )
        extra = dict(_trace_context())
        extra.update(getattr(record, "kv", None) or {})
        if extra:
            base += " " + " ".join(f"{k}={v}" for k, v in extra.items())
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


def setup(level: str = "info", fmt: str = "text") -> logging.Logger:
    logger = logging.getLogger(ROOT)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.propagate = False
    logger.handlers.clear()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_JsonFormatter() if fmt == "json" else _TextFormatter())
    logger.addHandler(handler)
    return logger


def get(name: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{name}")


def kv(**kwargs) -> dict:
    """Usage: log.info("allocated", extra=kv(chips=4, pod=uid))."""
    return {"kv": kwargs}
