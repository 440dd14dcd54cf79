"""Crash flight recorder: the last N telemetry events, always armed.

The JSONL sink (:mod:`.events`) answers "what happened" only when someone
remembered to set ``KATATPU_OBS=1`` before the incident — which is never
true for the incident that matters. This module keeps a bounded
in-memory ring of the most recent events (spans included — every closed
span is one event) REGARDLESS of the sink switch, and dumps the ring to
a postmortem JSONL file the moment a TERMINAL event passes through:

- ``serving/chip_loss_fatal``   — no degraded mesh rung left; the load
  failed (guest side);
- ``serving/fatal_error``       — a non-recoverable exception unwound the
  serving loop (user bug, strict-mode guard trip — the supervisor's
  "not ours to catch" class);
- ``plugin/registration_exhausted`` — the daemon gave up on kubelet
  registration (host side);
- ``serving/drain``             — only when the drain failed requests
  (``failed > 0``): work was shed, the 2 s before matter.

The dump is the answer to "what happened in the 2 seconds before the
mesh shrank": every span/event the process emitted leading up to the
terminal one, trace ids included, with zero configuration. Cost while
armed is one dict append per emitted event (events are emitted at the
scheduling cadence — admissions, retires, checkpoints — never per
token), bounded by the ring; ``KATATPU_FLIGHT=0`` disarms it entirely
and restores the sink-off fast path.

Knobs (env, read when the recorder is (re)configured):

- ``KATATPU_FLIGHT=0``      — kill switch (default armed);
- ``KATATPU_FLIGHT_RING``   — ring capacity in events (default 512);
- ``KATATPU_FLIGHT_DIR``    — dump directory (default: ``artifacts/``
  under the working dir — postmortems join the other telemetry
  artifacts instead of littering the repo/pod root).

Dumps are named ``katatpu_flight_<event>_<pid>_<seq>.jsonl`` so several
terminal events (or processes) never clobber each other. The module is
stdlib-only and imported by :mod:`.events` (never the reverse). It is a
copy of ``kata_xpu_device_plugin_tpu/obs/flight.py``: the same knobs, the
same dump names, so one postmortem reader serves both packages.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from collections import deque
from typing import Optional

ENV_ENABLE = "KATATPU_FLIGHT"   # "0" disarms; anything else (or unset) arms
ENV_RING = "KATATPU_FLIGHT_RING"
ENV_DIR = "KATATPU_FLIGHT_DIR"

DEFAULT_RING = 512
DEFAULT_DIR = "artifacts"

# (kind, name) pairs that always trigger a dump. serving/drain is
# conditional (failed > 0) and handled in _is_terminal.
TERMINAL_EVENTS = frozenset({
    ("serving", "chip_loss_fatal"),
    ("serving", "fatal_error"),
    ("plugin", "registration_exhausted"),
})


def enabled() -> bool:
    return os.environ.get(ENV_ENABLE, "1") != "0"


def ring_capacity() -> int:
    raw = os.environ.get(ENV_RING, "")
    try:
        n = int(raw) if raw else DEFAULT_RING
    except ValueError:
        n = DEFAULT_RING
    return max(1, n)


def dump_dir() -> str:
    return os.environ.get(ENV_DIR, "") or DEFAULT_DIR


class FlightRecorder:
    """Bounded ring of recent event dicts + the terminal-event dump.

    Thread-safe: concurrent emitters share the ring under one lock, and
    the dump runs inside it so the postmortem is a consistent snapshot
    (the terminal event is always the ring's last entry — record()
    appends before it checks the trigger)."""

    def __init__(self, capacity: int = DEFAULT_RING):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self.dumps: list[str] = []

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def record(self, event: dict) -> None:
        """Append one event; dump the ring when it is terminal. Never
        raises — the recorder is telemetry of last resort and must not
        add a failure mode to the path that is already failing."""
        with self._lock:
            self._ring.append(event)
            if not self._is_terminal(event):
                return
            try:
                self._dump_locked(str(event.get("name", "event")))
            except Exception:
                pass

    @staticmethod
    def _is_terminal(event: dict) -> bool:
        key = (event.get("kind"), event.get("name"))
        if key in TERMINAL_EVENTS:
            return True
        # A drain that shed work is an incident; a clean drain is not.
        if key == ("serving", "drain"):
            try:
                return int(event.get("failed") or 0) > 0
            except (TypeError, ValueError):
                return False
        return False

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Write the ring to a postmortem JSONL now (the terminal-event
        path calls the locked form itself); returns the path, or None
        when the ring is empty."""
        with self._lock:
            return self._dump_locked(reason)

    def _dump_locked(self, reason: str) -> Optional[str]:
        if not self._ring:
            return None
        d = dump_dir()
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
        # PROCESS-global sequence, not per-recorder: several recorder
        # instances in one process (the per-test fresh ring, a reconfig)
        # must never reuse a filename and overwrite an earlier
        # postmortem in a shared dump dir.
        path = os.path.join(
            d,
            f"katatpu_flight_{safe}_{os.getpid()}_{next(_DUMP_SEQ)}.jsonl",
        )
        # Sanctioned lock-held IO: a postmortem must be a consistent
        # snapshot — recording threads pausing behind the (rare) dump is
        # the cost of a ring that is not torn mid-capture.
        if d and d != ".":
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            for event in self._ring:
                fh.write(json.dumps(event, default=str) + "\n")
        self.dumps.append(path)
        return path


# -- process-default recorder ------------------------------------------------

# Dump-name uniqueness across every recorder instance this process makes
# (itertools.count.__next__ is atomic under the GIL).
_DUMP_SEQ = itertools.count(1)

_default: Optional[FlightRecorder] = None
_configured = False
_lock = threading.Lock()


def configure_from_env(force: bool = False) -> Optional[FlightRecorder]:
    """Resolve the default recorder from the environment (once; ``force``
    re-reads — tests that flip the env or need a fresh ring)."""
    global _default, _configured
    with _lock:
        if _configured and not force:
            return _default
        _configured = True
        _default = FlightRecorder(ring_capacity()) if enabled() else None
        return _default


def recorder() -> Optional[FlightRecorder]:
    """The process-default recorder (None when disarmed)."""
    return configure_from_env()


def set_default_recorder(
    rec: Optional[FlightRecorder],
) -> Optional[FlightRecorder]:
    """Install ``rec`` as the process default (None disarms); returns the
    previous recorder so callers can restore it — the sink-swap contract
    of :func:`..events.set_default_sink`."""
    global _default
    prev = configure_from_env()
    with _lock:
        _default = rec
        return prev
