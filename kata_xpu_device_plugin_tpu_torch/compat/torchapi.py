"""Strict mode and the steady-state tripwire of the port (counterpart of
``kata_xpu_device_plugin_tpu/compat/jaxapi.py``'s ``strict_mode``,
``allow_transfer``, ``TripwireCounts`` and ``compile_tripwire``).

**Strict mode** (``KATA_TPU_STRICT=1``, or ``strict=True`` on a server):
the overlapped serving round runs with ``torch.cuda.set_sync_debug_mode
("error")``, the twin of JAX's ``transfer_guard("disallow")``: any call
that makes the host wait for the card (``.item()``, ``.cpu()``, a
blocking copy, ``torch.cuda.synchronize()``) raises instead of silently
serializing the pipeline. :func:`allow_transfer` opens the sanctioned
regions, as in the JAX server: admission (the prompt's upload and the
first token's read), the :class:`..obs.trace.DeviceFence` retire, the
preemption spill and the prefix tier's demotion under pool pressure, a
fused admission's commit, and a decode graph's one-time capture. A trip
emits one ``strict``/``guard_trip`` event before the error propagates.
On the CPU there is nothing to guard: strict mode keeps its bookkeeping
(:func:`strict_depth`) and changes nothing.

**The tripwire** counts, over a server's steady-state drains (every
``run()`` after the first), the port's twins of JAX's two breaches:

- a *compile*: a decode executable built after the warm-up drain, that is
  the first dispatch of a new decode signature (a :class:`..guest.
  decode_graph.DecodeGraph` or ``PersistentRound``: one static step
  count, arena model, budget mask and sampling) and, on the card, each
  CUDA graph capture; plus any nvcc kernel build
  (:func:`..ops._build.build`). Counted by :func:`note_compile`.
  Prefill runs eagerly, so JAX's negative control (a bucket-less server
  and a new prompt length) is no compile here. The port's is the first
  fused dispatch of a persistent server whose warm-up drain never fused:
  its fixed-step chunk is a signature the warm-up never built (on the
  card, a graph capture);
- a *reshard*: a parameter or arena (or pool) tensor that moved to
  another address during the drain. A decode graph freezes those
  addresses, so a move is the port's placement change, the twin of an
  unsanctioned ``device_put``. Counted by comparing the addresses the
  caller's ``addresses()`` reports at the drain's start and end.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Callable, Optional

from ..constants import ENV_STRICT

_local = threading.local()


def strict_enabled(env: Optional[dict] = None) -> bool:
    """Is ``KATA_TPU_STRICT`` on? Servers read it at construction."""
    src = env if env is not None else os.environ
    return str(src.get(ENV_STRICT, "")).lower() in ("1", "true", "yes", "on")


def strict_depth() -> int:
    """Strict scopes open on this thread."""
    return getattr(_local, "strict", 0)


def _guarding() -> bool:
    return getattr(_local, "guarding", 0) > 0


def _set_mode(mode) -> None:
    import torch

    torch.cuda.set_sync_debug_mode(mode)


@contextmanager
def allow_transfer(reason: str = ""):
    """A sanctioned synchronous region inside :func:`strict_mode`
    (``reason`` documents the sanction at the call site). Outside a
    guarded scope it changes nothing."""
    del reason
    if not _guarding():
        yield
        return
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    _local.guarding -= 1
    _set_mode(0)
    try:
        yield
    finally:
        _local.guarding += 1
        _set_mode(prev)


def _looks_like_guard_trip(err: BaseException) -> bool:
    return "synchronizing" in str(err).lower()


@contextmanager
def strict_mode(*, scope: str = "strict", device=None):
    """Guard this scope against host synchronization with the card (module
    doc); ``device`` is the server's device, and a CPU device (or a process
    without CUDA) keeps the bookkeeping only."""
    import torch

    _local.strict = strict_depth() + 1
    guard = (torch.cuda.is_available()
             and (device is None or torch.device(device).type == "cuda"))
    prev = None
    if guard:
        prev = torch.cuda.get_sync_debug_mode()
        _local.guarding = getattr(_local, "guarding", 0) + 1
        _set_mode("error")
    try:
        yield
    except Exception as err:
        if guard and _looks_like_guard_trip(err):
            try:
                from .. import obs

                obs.emit("strict", "guard_trip", scope=scope,
                         error=f"{type(err).__name__}: {err}"[:300])
            except Exception:  # telemetry must not mask the error
                pass
        raise
    finally:
        _local.strict -= 1
        if guard:
            _local.guarding -= 1
            _set_mode(prev)


# ----- the steady-state tripwire ---------------------------------------------

_compiles = 0
_compiles_lock = threading.Lock()


def note_compile(what: str = "") -> None:
    """Count one compile (module doc): a new decode signature's first
    dispatch, a CUDA graph capture, or a kernel build."""
    del what
    global _compiles
    with _compiles_lock:
        _compiles += 1


def compile_counter() -> int:
    """Compiles counted in this process so far."""
    return _compiles


class TripwireCounts:
    """One :func:`compile_tripwire` scope's counts, final when it exits:
    ``compiles`` and ``transfers`` (the reshards: tensors that moved);
    ``armed`` whether the scope counted at all."""

    __slots__ = ("compiles", "transfers", "armed")

    def __init__(self) -> None:
        self.compiles = 0
        self.transfers = 0
        self.armed = False

    def __repr__(self) -> str:
        return (f"TripwireCounts(compiles={self.compiles}, "
                f"transfers={self.transfers}, armed={self.armed})")


@contextmanager
def compile_tripwire(enabled: bool = True,
                     addresses: Optional[Callable[[], dict]] = None):
    """Count compiles and reshards within this scope (module doc).
    ``addresses()`` returns ``{name: address}`` of the tensors whose moves
    count. Disabled, it yields counts that stay zero."""
    counts = TripwireCounts()
    if not enabled:
        yield counts
        return
    counts.armed = True
    start = compile_counter()
    before = addresses() if addresses is not None else {}
    try:
        yield counts
    finally:
        counts.compiles = compile_counter() - start
        if addresses is not None:
            after = addresses()
            counts.transfers = sum(1 for k, v in before.items()
                                   if after.get(k) != v)
