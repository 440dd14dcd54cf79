"""JSONL event stream: the one pipeline device-layer and workload-layer
telemetry share (a copy of ``kata_xpu_device_plugin_tpu/obs/events.py``, so
the device plugin's heartbeat aggregator and ``tools/obs_report.py`` read
this package's stream as they read the JAX package's).

Every event is one JSON object per line::

    {"ts": 1722700000.123, "kind": "span", "name": "train.step", ...}

Producers call :func:`emit` (or pass a sink explicitly); consumers —
``bench.py``, tests, offline analysis — call :func:`read_events` and
:func:`summarize_phases`. The default sink is configured from the
environment exactly once:

- ``KATATPU_OBS=1`` (alias ``KATA_TPU_OBS=1``) enables the stream;
- ``KATATPU_OBS_FILE`` names the output path (default
  ``katatpu_events.jsonl`` in the working directory).

With the stream disabled, :func:`emit` is a dict lookup and a ``None``
check — instrumented hot paths pay nothing.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import IO, Iterable, Optional

from . import flight

_ENV_ENABLE = ("KATATPU_OBS", "KATA_TPU_OBS")
_ENV_FILE = ("KATATPU_OBS_FILE", "KATA_TPU_OBS_FILE")
_DEFAULT_FILE = "katatpu_events.jsonl"
_TRUTHY = ("1", "true", "yes", "on")


def enabled() -> bool:
    """Is the JSONL event stream switched on (``KATATPU_OBS=1``)?"""
    return any(
        os.environ.get(k, "").lower() in _TRUTHY for k in _ENV_ENABLE
    )


def events_path() -> str:
    for k in _ENV_FILE:
        v = os.environ.get(k, "")
        if v:
            return v
    return _DEFAULT_FILE


class EventSink:
    """Append-only, thread-safe JSONL writer.

    Opens lazily on first emit (an enabled-but-idle process creates no
    file); every line is flushed so a crashed or SIGKILLed worker loses at
    most the event in flight — the stream is evidence, buffered evidence
    evaporates.
    """

    def __init__(self, path: str, clock=time.time):
        self.path = path
        self._clock = clock
        self._lock = threading.Lock()
        self._fh: Optional[IO[str]] = None
        self._emitted = 0

    def emit(self, kind: str, name: str, **fields) -> dict:
        event = {"ts": round(self._clock(), 6), "kind": kind, "name": name}
        event.update(fields)
        line = json.dumps(event, default=_jsonable, sort_keys=False)
        with self._lock:
            # Sanctioned lock-held IO: the lazy open + torn-line probe
            # happen ONCE per sink, and per-line append/flush is the
            # sink's whole serialization contract — emitters must not
            # interleave bytes.
            if self._fh is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)  # torchguard: allow(TG203) one-shot lazy open
                self._fh = open(self.path, "a", encoding="utf-8")  # torchguard: allow(TG203) one-shot lazy open
                # A previous writer killed mid-line leaves no trailing
                # newline; appending onto the torn line would corrupt THIS
                # sink's first event too. Terminate it.
                if self._fh.tell() > 0:
                    with open(self.path, "rb") as probe:  # torchguard: allow(TG203) one-shot torn-line probe
                        probe.seek(-1, os.SEEK_END)
                        torn = probe.read(1) != b"\n"
                    if torn:
                        self._fh.write("\n")
            self._fh.write(line + "\n")
            self._fh.flush()
            self._emitted += 1
        return event

    @property
    def emitted(self) -> int:
        return self._emitted

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "EventSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(obj):
    """Last-resort encoder: tensors and numpy values → python numbers/lists,
    everything else → str. Telemetry must never raise out of a hot path."""
    for attr in ("item", "tolist"):
        fn = getattr(obj, attr, None)
        if fn is not None:
            try:
                return fn()
            except Exception:
                break
    return str(obj)


# -- process-default sink ----------------------------------------------------

_default: Optional[EventSink] = None
_configured = False
_lock = threading.Lock()


def configure_from_env(force: bool = False) -> Optional[EventSink]:
    """Resolve the default sink from the environment (once; ``force``
    re-reads, for tests that flip the env)."""
    global _default, _configured
    with _lock:
        if _configured and not force:
            return _default
        _configured = True
        _default = EventSink(events_path()) if enabled() else None
        return _default


def set_default_sink(sink: Optional[EventSink]) -> Optional[EventSink]:
    """Install ``sink`` as the process default (None disables); returns the
    previous sink so callers can restore it. The env default is resolved
    FIRST, so a caller that swaps and later restores hands back the
    ``KATATPU_OBS`` sink rather than erasing it."""
    global _default
    prev = configure_from_env()
    with _lock:
        _default = sink
        return prev


def default_sink() -> Optional[EventSink]:
    return configure_from_env()


def emit(kind: str, name: str, **fields) -> Optional[dict]:
    """Emit to the default sink; returns None when the sink is disabled.

    The crash FLIGHT RECORDER (:mod:`.flight`) sees every event emitted
    here regardless of the sink switch — its bounded in-memory ring is
    always armed (``KATATPU_FLIGHT=0`` disarms), so a terminal event
    (``chip_loss_fatal``, ``registration_exhausted``, a failed drain)
    can dump the recent past even when nobody enabled ``KATATPU_OBS``
    before the incident."""
    sink = default_sink()
    event: Optional[dict] = None
    if sink is not None:
        event = sink.emit(kind, name, **fields)
    rec = flight.recorder()
    if rec is not None:
        if event is None:
            event = {"ts": round(time.time(), 6), "kind": kind, "name": name}
            event.update(fields)
            rec.record(event)
            return None  # sink disabled: keep the old return contract
        rec.record(event)
    return event


# -- consumers ---------------------------------------------------------------


def read_events(path: str, offset: int = 0) -> list[dict]:
    """Parse a JSONL event file back into dicts (skipping any torn final
    line a killed writer may have left). ``offset`` skips the first N
    bytes — pass the file's size from before your run started to read
    only your own events from a shared/pinned stream (the sink appends,
    and always lands new events on a line boundary: it completes every
    line it writes and terminates any torn tail it inherits, so a
    pre-run size is always a valid resume point)."""
    out: list[dict] = []
    with open(path, encoding="utf-8") as fh:
        if offset:
            fh.seek(offset)
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def tail_events(path: str, offset: int = 0) -> tuple[list[dict], int]:
    """Incremental, rotation-safe tail of a JSONL event file:
    parse the COMPLETE lines past byte ``offset`` and return them with
    the offset to resume from — so pollers (the SLO watchdog, the
    daemon-side heartbeat aggregator, ``bench_watch``) stop re-reading
    whole files every pass.

    Contract:

    - The returned offset always lands on a line boundary: a torn final
      line (a writer killed or caught mid-``write``) is NOT consumed —
      the next call picks it up once the writer completes it, so no
      event is ever half-parsed or skipped.
    - Rotation/truncation safe: when the file shrank below ``offset``
      (logrotate, a fresh sink truncating) the tail restarts from byte
      0 instead of silently returning nothing forever. A truncated file
      that REGREW past the old offset between polls is caught by the
      line-boundary check below (a valid resume offset always sits just
      after a newline; rewritten content almost never does) — the
      residual blind spot is a regrown file whose new content happens
      to place a newline exactly at ``offset - 1``, in which case the
      spliced lines are skipped as corrupt rather than mis-parsed.
    - A missing file returns ``([], 0)`` — the poller's steady state
      before the guest emits its first event.

    Complete-but-unparseable lines are skipped (the ``read_events``
    leniency) but their bytes ARE consumed — a corrupt line must not
    wedge the tail on every subsequent poll."""
    out: list[dict] = []
    try:
        size = os.path.getsize(path)
    except OSError:
        return out, 0
    if size < offset:
        offset = 0  # rotated/truncated under us: the stream restarted
    if size == offset:
        return out, offset
    with open(path, "rb") as fh:
        if offset:
            # Every offset this function returns lands just past a
            # newline; if that byte is no longer one, the file was
            # truncated AND regrew past the old offset between polls —
            # restart from 0 rather than splicing into the new stream.
            fh.seek(offset - 1)
            if fh.read(1) != b"\n":
                offset = 0
        fh.seek(offset)
        data = fh.read(size - offset)
    # Only complete lines are consumed; a torn tail stays unread.
    end = data.rfind(b"\n") + 1
    if end == 0:
        return out, offset
    for line in data[:end].splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line.decode("utf-8")))
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue
    return out, offset + end


def summarize_phases(
    events: Iterable[dict], prefix: str = ""
) -> dict[str, dict]:
    """Aggregate span events into per-phase timing: ``{phase: {count,
    total_s, min_s, max_s, mean_s}}``. ``prefix`` selects and strips a
    namespace (``prefix="bench."`` turns ``bench.decode`` into ``decode``)
    — this is how ``bench.py`` converts the stream into the per-phase
    breakdown BENCH_*.json reports."""
    acc: dict[str, list[float]] = {}
    for ev in events:
        if ev.get("kind") != "span" or "dur_s" not in ev:
            continue
        name = str(ev.get("name", ""))
        if prefix:
            if not name.startswith(prefix):
                continue
            name = name[len(prefix):]
        acc.setdefault(name, []).append(float(ev["dur_s"]))
    return {
        name: {
            "count": len(durs),
            "total_s": round(sum(durs), 6),
            "min_s": round(min(durs), 6),
            "max_s": round(max(durs), 6),
            "mean_s": round(sum(durs) / len(durs), 6),
        }
        for name, durs in sorted(acc.items())
    }
