"""Fault injection and crash-tolerance primitives of the serving loop
(counterpart of ``kata_xpu_device_plugin_tpu/guest/resilience.py``; this
package keeps its own copy and imports nothing of the JAX one).

- :class:`FaultInjector`: a seeded, schedule-driven injector crossed at
  named SEAMS around the serving loop's real failure points
  (``decode_dispatch``, ``prefill``, ``admission_commit``, ``fence``,
  ``pool_alloc``, ``store_gather``, ``sched_tick``). A schedule is a
  comma-separated ``<seam>:<round>[:<kind>[:<device>]]`` list
  (``KATA_TPU_FAULTS``): ``round`` is the seam's 0-based crossing count,
  ``kind`` one of ``raise-transient`` (default), ``raise-oom``, ``hang``,
  or the permanent kinds ``chip_loss`` (fourth field: the lost shard's
  index in the serving mesh) and ``ici_error``. Each entry fires once, so
  the same schedule over the same requests gives the same faults, in the
  JAX server as here: both cross every seam as often for the same
  requests and settings. The injector draws from ``random.Random(seed)``,
  the JAX injector's sequence. Malformed env entries are skipped with a
  ``fault_schedule_error`` event.
- :func:`fence_with_timeout`: the watchdog fence. With a deadline
  (``KATA_TPU_FENCE_TIMEOUT_S``) a blocking wait runs on a pooled worker
  thread, and a ``device_stall`` event and :class:`DeviceStallError`
  replace a hang; without one the wait runs inline.
- :func:`classify` / :func:`recoverable`: the supervisor's triage. Injected
  transient kinds and stalls are TRANSIENT (rebuild and replay), injected
  ``chip_loss``/``ici_error`` PERMANENT (shrink the serving mesh). Errors
  from CUDA are matched on their text, a ``RuntimeError`` (which
  ``torch.AcceleratorError`` is) whose message holds ``"CUDA error"``:

  ==================================================  ============  =================================
  exception                                           verdict       why
  ==================================================  ============  =================================
  ``torch.cuda.OutOfMemoryError``; "out of memory"    TRANSIENT     the ``RESOURCE_EXHAUSTED`` analog
  "uncorrectable ECC error"                           PERMANENT     the memory is gone
  "uncorrectable NVLink error"                        PERMANENT     the ICI analog
  "busy or unavailable"                               PERMANENT     the card is taken or lost
  "no CUDA-capable device"                            PERMANENT     the card is lost
  "unspecified launch failure"                        PERMANENT     the context is lost
  "illegal memory access", "illegal instruction",     None          a program fault: it propagates
  "misaligned address", "device-side assert",                       (``fatal_error`` and a flight
  "invalid argument", "too many resources requested"                dump), the JAX rule for bugs
  ==================================================  ============  =================================

  Any other exception, and any other CUDA error, is None. A real
  PERMANENT error takes the server's one card, and every shard of its
  :class:`.tp_serving.ServingMesh` with it: the shrink finds no survivor
  and the load fails loudly (``chip_loss_fatal``, ``why="single_chip"``).
- :func:`env_int` / :func:`env_float`: integer and float env knobs that
  degrade to their default with one event on a malformed value.
- :func:`wire_drain`: SIGTERM and a maintenance-notice file
  (``KATA_TPU_MAINTENANCE_FILE``) call the server's ``request_drain``.

The supervisor itself is :class:`.serving.GenerationServer`'s ``step``.
"""
from __future__ import annotations

import os
import queue
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import torch

from .. import obs
from ..constants import (
    ENV_FAULTS,
    ENV_FAULTS_SEED,
    ENV_FENCE_TIMEOUT,
    ENV_MAINTENANCE_FILE,
)

# Named seams — the serving loop's real failure surfaces. fire() rejects
# anything else so a typo'd schedule cannot silently never fire.
SEAMS = (
    "decode_dispatch",   # the chunked decode executable dispatch
    "prefill",           # an admission's prefill forward
    "admission_commit",  # the arena/pool write landing an admission
    "fence",             # a blocking device->host wait (retire, lock-step)
    "pool_alloc",        # paged block allocation (OOM surface)
    "store_gather",      # prefix-store gather/materialize on a hit
    "sched_tick",        # a chunked-prefill slice boundary
)

KIND_TRANSIENT = "raise-transient"
KIND_OOM = "raise-oom"
KIND_HANG = "hang"
# Permanent fault kinds: the device does not come back on
# retry. ``chip_loss`` optionally carries the lost chip's serving-mesh
# device index as a FOURTH schedule field (``<seam>:<round>:chip_loss:1``,
# default 0); ``ici_error`` models an interconnect failure — chips alive,
# collectives untrustworthy.
KIND_CHIP_LOSS = "chip_loss"
KIND_ICI = "ici_error"
KINDS = (KIND_TRANSIENT, KIND_OOM, KIND_HANG, KIND_CHIP_LOSS, KIND_ICI)
PERMANENT_KINDS = (KIND_CHIP_LOSS, KIND_ICI)

# classify() verdicts.
TRANSIENT = "transient"
PERMANENT = "permanent"


class TransientFault(RuntimeError):
    """Injected transient dispatch failure (the retryable class)."""


class InjectedOom(RuntimeError):
    """Injected allocation failure; its message carries the JAX server's
    ``RESOURCE_EXHAUSTED`` marker, and :func:`classify` takes it as
    TRANSIENT, as it does a real CUDA out-of-memory error."""


class DeviceStallError(TimeoutError):
    """A device fence exceeded its watchdog deadline (real or injected) —
    the bounded replacement for a fence wait that never returns."""


class ChipLossFault(RuntimeError):
    """Injected PERMANENT chip failure: serving-mesh shard
    ``device_index`` is gone and will not come back on retry — the
    supervisor must shrink the mesh over the survivors (or fail the load
    loudly), never replay into the dead chip."""

    def __init__(self, message: str, device_index: int = 0):
        super().__init__(message)
        self.device_index = int(device_index)


class IciFault(RuntimeError):
    """Injected PERMANENT ICI interconnect failure: the chips answer but
    collectives across the mesh are untrustworthy — same elastic-shrink
    recovery class as :class:`ChipLossFault`, with every chip surviving."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``kind`` at the ``round``-th invocation
    (0-based, counted per seam) of ``seam``. ``device`` is meaningful for
    ``chip_loss`` only: the serving-mesh index of the chip that dies."""

    seam: str
    round: int
    kind: str = KIND_TRANSIENT
    device: int = 0


def parse_schedule(raw: str) -> tuple[list[FaultSpec], list[str]]:
    """Parse a ``<seam>:<round>[:<kind>[:<device>]],...`` schedule string
    into specs plus the malformed entries (the caller decides whether to
    event or raise on those — the env path degrades, the explicit path
    raises). The fourth field is valid only for ``chip_loss`` (the lost
    chip's serving-mesh device index, default 0)."""
    specs: list[FaultSpec] = []
    bad: list[str] = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3, 4) or parts[0] not in SEAMS:
            bad.append(entry)
            continue
        kind = parts[2] if len(parts) >= 3 else KIND_TRANSIENT
        if kind not in KINDS:
            bad.append(entry)
            continue
        device = 0
        if len(parts) == 4:
            # Only chip_loss carries a device index — a fourth field on
            # any other kind is a malformed entry, not a silent ignore.
            if kind != KIND_CHIP_LOSS:
                bad.append(entry)
                continue
            try:
                device = int(parts[3])
            except ValueError:
                bad.append(entry)
                continue
            if device < 0:
                bad.append(entry)
                continue
        try:
            rnd = int(parts[1])
        except ValueError:
            bad.append(entry)
            continue
        if rnd < 0:
            bad.append(entry)
            continue
        specs.append(FaultSpec(parts[0], rnd, kind, device))
    return specs, bad


@dataclass
class FaultInjector:
    """Deterministic scheduled fault source. ``fire(seam)`` is called at
    every seam crossing; when the seam's invocation count matches a
    scheduled entry, the entry is consumed and the fault raised
    (``fault_injected`` event first). Disarmed (empty schedule — the
    production default) the per-call cost is one attribute test.

    ``seed`` keys the injector's RNG — today only hang jitter draws from
    it, but it is part of the replay contract: (seed, schedule) fully
    determines the fired sequence, recorded in :attr:`fired`.
    """

    schedule: Iterable[FaultSpec] = ()
    seed: int = 0
    label: str = ""
    # Allocation trace id: attached to every fault_injected /
    # device_stall event so a chaos run's injections join the request
    # traces and flight-recorder dumps of the same incident.
    trace: str = ""
    hang_s: float = 0.0  # optional real delay before an injected stall
    fired: list = field(default_factory=list)

    def __post_init__(self) -> None:
        pending: dict[tuple[str, int], FaultSpec] = {}
        for spec in self.schedule:
            if spec.seam not in SEAMS:
                raise ValueError(
                    f"unknown fault seam {spec.seam!r} (have {SEAMS})"
                )
            if spec.kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {spec.kind!r} (have {KINDS})"
                )
            pending[(spec.seam, spec.round)] = spec
        self._pending = pending
        self._counts: dict[str, int] = {}
        self._rng = random.Random(self.seed)

    @classmethod
    def from_env(cls, label: str = "", trace: str = "") -> "FaultInjector":
        """The injector the serving loop builds by default: schedule from
        ``KATA_TPU_FAULTS`` (the env the daemon's ``--faults`` chaos knob
        injects), seed from ``KATA_TPU_FAULTS_SEED``. Malformed entries
        are skipped with one ``fault_schedule_error`` event each — the
        node-wide knob must never crash a guest."""
        raw = os.environ.get(ENV_FAULTS, "")
        specs, bad = parse_schedule(raw) if raw else ([], [])
        for entry in bad:
            obs.emit(
                "serving", "fault_schedule_error",
                server=label, entry=entry[:64],
            )
        try:
            seed = int(os.environ.get(ENV_FAULTS_SEED, "0") or 0)
        except ValueError:
            seed = 0
        return cls(schedule=specs, seed=seed, label=label, trace=trace)

    @property
    def armed(self) -> bool:
        return bool(self._pending)

    def fire(self, seam: str) -> None:
        """Cross ``seam``: raise the scheduled fault for this invocation,
        if any. No-op (one dict truth-test) when the schedule is drained
        or empty."""
        if not self._pending:
            return
        if seam not in SEAMS:
            raise ValueError(f"unknown fault seam {seam!r}")
        n = self._counts.get(seam, 0)
        self._counts[seam] = n + 1
        spec = self._pending.pop((seam, n), None)
        if spec is None:
            return
        kind = spec.kind
        self.fired.append((seam, n, kind))
        extra = {"device": spec.device} if kind == KIND_CHIP_LOSS else {}
        if self.trace:
            extra["trace"] = self.trace
        obs.emit(
            "serving", "fault_injected",
            server=self.label, seam=seam, round=n, fault_kind=kind,
            **extra,
        )
        if kind == KIND_TRANSIENT:
            raise TransientFault(f"injected transient fault at {seam}#{n}")
        if kind == KIND_OOM:
            raise InjectedOom(
                f"RESOURCE_EXHAUSTED: injected allocation failure at "
                f"{seam}#{n}"
            )
        if kind == KIND_CHIP_LOSS:
            raise ChipLossFault(
                f"injected permanent chip loss at {seam}#{n} "
                f"(mesh device {spec.device})",
                device_index=spec.device,
            )
        if kind == KIND_ICI:
            raise IciFault(
                f"injected permanent ICI interconnect failure at {seam}#{n}"
            )
        # hang: a simulated stall — the watchdog deadline is short-
        # circuited deterministically (an optional real hang_s delay keeps
        # wall-clock shape when wanted) so chaos tests never actually wait
        # out a production deadline.
        if self.hang_s > 0:
            time.sleep(self.hang_s * (0.5 + self._rng.random()))
        obs.emit(
            "serving", "device_stall",
            server=self.label, seam=seam, injected=True,
            **({"trace": self.trace} if self.trace else {}),
        )
        raise DeviceStallError(f"injected device stall at {seam}#{n}")


class _FenceWorker:
    """One reusable watchdog thread. Armed fences borrow a worker from
    the pool instead of paying a thread spawn per wait (the armed path
    runs at the decode-chunk cadence); a wait that times out ABANDONS
    its worker — the thread is stuck inside the hung call, nothing can
    interrupt a stuck transport — and the next fence draws a fresh one.
    A completed wait returns its worker to the pool."""

    def __init__(self) -> None:
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self.abandoned = False
        threading.Thread(target=self._loop, name="katatpu-fence-watchdog",
                         daemon=True).start()

    def _loop(self) -> None:
        while True:
            wait, box, done = self._q.get()
            try:
                box["value"] = wait()
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                box["error"] = e
            finally:
                done.set()
            if self.abandoned:
                # The caller timed out while we ran and forgot us. (A
                # caller racing its abandoned-mark against this check can
                # at worst strand one idle thread — same order of leak as
                # the hung wait itself.)
                return
            with _FENCE_POOL_LOCK:
                _FENCE_POOL.append(self)


_FENCE_POOL: list[_FenceWorker] = []
_FENCE_POOL_LOCK = threading.Lock()


def _borrow_fence_worker() -> _FenceWorker:
    with _FENCE_POOL_LOCK:
        while _FENCE_POOL:
            w = _FENCE_POOL.pop()
            if not w.abandoned:
                return w
    return _FenceWorker()


def fence_with_timeout(
    wait: Callable[[], object],
    *,
    timeout_s: float = 0.0,
    seam: str = "fence",
    injector: Optional[FaultInjector] = None,
    server: str = "",
    trace: str = "",
) -> object:
    """Run a blocking device wait (``wait`` is a zero-arg callable — a
    ``DeviceFence.wait`` / ``block_until_ready`` / host-transfer closure)
    under the watchdog contract: with ``timeout_s > 0`` the wait runs on
    a daemon thread and exceeding the deadline emits a ``device_stall``
    event and raises :class:`DeviceStallError` instead of hanging the
    scheduler forever (the abandoned thread keeps blocking — nothing can
    interrupt a stuck transport, but the SERVER regains control and can
    rebuild). With ``timeout_s`` unset (default) the wait runs inline —
    no thread, no overhead, bit-for-bit the pre-watchdog behavior.

    ``injector`` crosses the ``seam`` first, so a scheduled ``hang``
    becomes a deterministic stall without waiting out the deadline."""
    if injector is not None:
        injector.fire(seam)
    if not timeout_s or timeout_s <= 0:
        return wait()
    worker = _borrow_fence_worker()
    box, done = {}, threading.Event()
    worker._q.put((wait, box, done))
    if not done.wait(timeout_s):
        worker.abandoned = True
        obs.emit(
            "serving", "device_stall",
            server=server, seam=seam, timeout_s=round(float(timeout_s), 3),
            injected=False,
            **({"trace": trace} if trace else {}),
        )
        raise DeviceStallError(
            f"device fence {seam!r} exceeded {timeout_s}s watchdog deadline"
        )
    if "error" in box:
        raise box["error"]
    return box.get("value")


# Texts of CUDA errors (module doc's table). A PERMANENT one loses the card;
# a program fault is none of these and propagates.
_CUDA_ERROR = "CUDA error"
_TRANSIENT_MARKERS = ("out of memory",)
_PERMANENT_MARKERS = (
    "uncorrectable ecc error",
    "uncorrectable nvlink error",
    "busy or unavailable",
    "no cuda-capable device",
    "unspecified launch failure",
)


def classify(exc: BaseException) -> Optional[str]:
    """The supervisor's fault triage: :data:`TRANSIENT` rebuilds and
    replays, :data:`PERMANENT` shrinks the serving mesh, None is not ours
    to catch and propagates (the module doc's table)."""
    if isinstance(exc, (ChipLossFault, IciFault)):
        return PERMANENT
    if isinstance(exc, (TransientFault, InjectedOom, DeviceStallError)):
        return TRANSIENT
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return TRANSIENT
    if isinstance(exc, RuntimeError) and _CUDA_ERROR in str(exc):
        low = str(exc).lower()
        if any(marker in low for marker in _PERMANENT_MARKERS):
            return PERMANENT
        if any(marker in low for marker in _TRANSIENT_MARKERS):
            return TRANSIENT
    return None


def recoverable(exc: BaseException) -> bool:
    """Should the supervisor catch ``exc`` and rebuild, rather than let it
    unwind the server? Injected faults and stalls always; CUDA errors only
    when their text says the device, not the program, failed."""
    return classify(exc) is not None


def env_int(name: str, default: int, *, event: str = "",
            server: str = "", trace: str = "") -> int:
    """Integer env knob with the repo's degrade contract: a malformed
    node-injected value falls back to ``default`` with one ``event``
    (reason ``bad_env:<raw>``) instead of crashing the guest. ``trace``
    joins the degrade event to the allocation trace."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        if event:
            obs.emit("serving", event, server=server,
                     reason=f"bad_env:{raw[:32]}",
                     **({"trace": trace} if trace else {}))
        return default


def env_float(name: str, default: float, *, event: str = "",
              server: str = "", trace: str = "") -> float:
    """Float sibling of :func:`env_int` (same degrade contract)."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        if event:
            obs.emit("serving", event, server=server,
                     reason=f"bad_env:{raw[:32]}",
                     **({"trace": trace} if trace else {}))
        return default


class DrainWiring:
    """Handle returned by :func:`wire_drain`: owns the maintenance-watch
    thread and the restored SIGTERM disposition. ``stop()`` detaches both
    (idempotent); ``poll_once()`` runs one maintenance check inline for
    deterministic tests."""

    def __init__(self, server, maintenance_file: str = "",
                 poll_s: float = 1.0):
        self._server = server
        self._file = maintenance_file
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_handler = None
        self._sigterm_installed = False

    def poll_once(self) -> bool:
        """One maintenance-notice check; True when it triggered a drain."""
        if self._file and os.path.exists(self._file):
            self._server.request_drain(reason="maintenance_notice")
            return True
        return False

    def _watch(self) -> None:
        while not self._stop.is_set():
            if self.poll_once():
                return
            self._stop.wait(self._poll_s)

    def _start_watch(self) -> None:
        self._thread = threading.Thread(
            target=self._watch, name="katatpu-maintenance-watch", daemon=True
        )
        self._thread.start()

    def _install_sigterm(self) -> None:
        def handler(signum, frame):
            self._server.request_drain(reason="sigterm")
            # Chain a CALLABLE prior handler so a process manager layering
            # its own hook still observes the signal. A SIG_DFL prior
            # disposition is deliberately NOT chained — immediate
            # termination is exactly what the drain exists to prevent;
            # exiting once run() returns is the caller's job.
            if callable(self._prev_handler):
                self._prev_handler(signum, frame)

        try:
            self._prev_handler = signal.signal(signal.SIGTERM, handler)
            self._sigterm_installed = True
        except ValueError:
            # Not the main thread: signal wiring is unavailable there by
            # interpreter rule; the maintenance watch still works.
            self._sigterm_installed = False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._sigterm_installed:
            try:
                signal.signal(signal.SIGTERM, self._prev_handler
                              or signal.SIG_DFL)
            except ValueError:
                pass
            self._sigterm_installed = False

    def __enter__(self) -> "DrainWiring":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def wire_drain(server, *, sigterm: bool = True,
               maintenance_file: Optional[str] = None,
               poll_s: float = 1.0) -> DrainWiring:
    """Wire a server's graceful drain to the two production triggers:
    SIGTERM (pod termination) and a maintenance-notice file
    (``maintenance_file``, default ``KATA_TPU_MAINTENANCE_FILE`` env —
    the path the host surfaces a maintenance event on). Either
    trigger calls ``server.request_drain(...)``: admission stops,
    in-flight work finishes, still-queued requests surface in
    ``failures()``. Returns a :class:`DrainWiring`; call ``stop()`` (or
    use as a context manager) to detach."""
    if maintenance_file is None:
        maintenance_file = os.environ.get(ENV_MAINTENANCE_FILE, "")
    wiring = DrainWiring(server, maintenance_file, poll_s)
    if sigterm:
        wiring._install_sigterm()
    if maintenance_file:
        wiring._start_watch()
    return wiring
