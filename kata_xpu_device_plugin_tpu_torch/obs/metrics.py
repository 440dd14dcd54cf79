"""Host-side latency summaries (a copy of ``Rolling`` from
``kata_xpu_device_plugin_tpu/obs/metrics.py``)."""
from __future__ import annotations

import threading
from typing import Optional


class Rolling:
    """count/sum/min/max plus a bounded reservoir of the most recent values
    for p50/p95/p99. Thread-safe; ``summary()`` returns plain floats."""

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
