"""Optional ``torch.profiler`` hook: trace a configurable window of steps
(counterpart of ``kata_xpu_device_plugin_tpu/obs/profiler.py``).

Construct a :class:`ProfilerHook` (or let :func:`profiler_from_env` build
one from ``KATATPU_OBS_PROFILE_DIR`` / ``KATATPU_OBS_PROFILE_START`` /
``KATATPU_OBS_PROFILE_STEPS``) and call ``on_step(step)`` once a step: the
hook starts ``torch.profiler`` (CPU activity, and CUDA where a card is
present) at ``start_step``, stops it ``num_steps`` later and writes a
Chrome trace, ``torch_trace_<pid>_<n>.json``, into the directory.
``stop()`` is idempotent and also runs on ``close``, so an exception
mid-window cannot leave the profiler running. ``torch.profiler`` is
imported when a window opens, never at import.

One trace runs per process: two hooks may race for it (an env-armed
window and the watchdog's alert window). The loser marks itself done and
emits one ``profiler_busy`` event instead of raising out of the loop.

A closed window emits one ``profile`` event named ``torch_trace`` (the
JAX package's hook names it ``jax_trace``) with ``dir``, ``start_step``,
``stop_step`` and this port's ``path`` of the trace file. The port keeps
the event's kind and fields and renames it after the profiler that wrote
the file: no consumer in the repository keys on the name (the daemon's
heartbeat aggregator and ``tools/obs_report.py`` read neither profile
event); a reader of both packages' streams selects kind ``profile``.
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
from typing import Optional

from . import events

LOG = logging.getLogger(__name__)

# Process-wide trace ownership: hooks claim the slot under this lock
# before touching the profiler at all.
_trace_lock = threading.Lock()
_trace_owner: Optional["ProfilerHook"] = None
_TRACE_SEQ = itertools.count(1)

_ENV_DIR = ("KATATPU_OBS_PROFILE_DIR", "KATA_TPU_OBS_PROFILE_DIR")
_ENV_START = ("KATATPU_OBS_PROFILE_START", "KATA_TPU_OBS_PROFILE_START")
_ENV_STEPS = ("KATATPU_OBS_PROFILE_STEPS", "KATA_TPU_OBS_PROFILE_STEPS")


def _env(names: tuple, default: str = "") -> str:
    for n in names:
        v = os.environ.get(n, "")
        if v:
            return v
    return default


class ProfilerHook:
    """Profile steps ``[start_step, start_step + num_steps)`` (1-indexed,
    the trainer's step numbering)."""

    def __init__(self, profile_dir: str, start_step: int = 2,
                 num_steps: int = 3):
        if start_step < 1:
            raise ValueError(f"start_step must be >= 1, got {start_step}")
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        self.profile_dir = profile_dir
        self.start_step = start_step
        self.stop_after = start_step + num_steps - 1
        self.trace_path: Optional[str] = None
        self._prof = None
        self._done = False

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def on_step(self, step: int) -> None:
        """Call AFTER step ``step`` completes (the trainer also primes the
        hook with the step it resumes from): the window opens once
        ``start_step - 1`` has completed and covers through
        ``stop_after``; by default from step 2, past the first step's
        one-time costs. A resume already past the window never opens it."""
        if (not self._done and not self._active
                and self.start_step - 1 <= step < self.stop_after):
            self._start()
        elif self._active and step >= self.stop_after:
            self.stop()

    def _busy(self, reason: str) -> None:
        """Lost the process-wide trace slot: give this hook's window up for
        good and say why, instead of raising out of the caller's loop."""
        self._done = True
        events.emit(
            "profile", "profiler_busy",
            dir=self.profile_dir, start_step=self.start_step,
            stop_step=self.stop_after, reason=reason,
        )
        LOG.warning("profiler window skipped (%s): trace already running",
                    reason)

    def _start(self) -> None:
        global _trace_owner
        with _trace_lock:
            if _trace_owner is not None:
                owner = _trace_owner
            else:
                owner, _trace_owner = None, self
        if owner is not None:
            self._busy(f"owned:{owner.profile_dir}")
            return
        import torch
        import torch.profiler as tp

        os.makedirs(self.profile_dir, exist_ok=True)
        activities = [tp.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(tp.ProfilerActivity.CUDA)
        try:
            prof = tp.profile(activities=activities)
            prof.start()
        except Exception as exc:
            # A profiler some caller started without a hook: same degrade,
            # and the slot is released.
            with _trace_lock:
                if _trace_owner is self:
                    _trace_owner = None
            self._busy(f"start:{type(exc).__name__}")
            return
        self._prof = prof
        LOG.info("profiler trace started in %s (steps %d-%d)",
                 self.profile_dir, self.start_step, self.stop_after)

    def stop(self) -> None:
        global _trace_owner
        prof, self._prof = self._prof, None
        if prof is None:
            return
        path = os.path.join(
            self.profile_dir,
            f"torch_trace_{os.getpid()}_{next(_TRACE_SEQ)}.json")
        try:
            prof.stop()
            prof.export_chrome_trace(path)
            self.trace_path = path
        finally:
            self._done = True
            with _trace_lock:
                if _trace_owner is self:
                    _trace_owner = None
        events.emit(
            "profile", "torch_trace", dir=self.profile_dir,
            start_step=self.start_step, stop_step=self.stop_after, path=path,
        )
        LOG.info("profiler trace written to %s", path)

    def close(self) -> None:
        self.stop()

    def __enter__(self) -> "ProfilerHook":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def profiler_from_env() -> Optional[ProfilerHook]:
    """A hook from ``KATATPU_OBS_PROFILE_DIR`` (with optional ``_START`` and
    ``_STEPS``); None when the directory is unset."""
    profile_dir = _env(_ENV_DIR)
    if not profile_dir:
        return None
    return ProfilerHook(
        profile_dir,
        start_step=int(_env(_ENV_START, "2")),
        num_steps=int(_env(_ENV_STEPS, "3")),
    )
