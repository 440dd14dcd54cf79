"""Spans with honest device timing, and the device-to-host fence of
overlapped serving (counterpart of ``kata_xpu_device_plugin_tpu/obs/trace.py``).

A ``perf_counter`` pair around a CUDA call measures the launch: the card
may still be running when the second stamp is read. A span closes that
hole: any value registered through ``Span.fence(x)`` (or ``fence=``) is
waited for before the end stamp, so the duration covers the device work.
The fence of a CUDA tensor records a ``torch.cuda.Event`` on the current
stream of the tensor's device (the stream the serving loop and the
trainer issue their work on) and synchronizes that event only, as
:class:`DeviceFence` does. It never calls ``torch.cuda.synchronize()``,
which would also wait for the side streams (the fused admission's slice,
the resume prefetch) that the span does not cover. A CPU tensor needs no
fence; inside a CUDA-graph capture nothing is fenced (a synchronize there
would break the capture).

APIs, as in the JAX package:

- :func:`span` — context manager; nesting builds a parent/child tree under
  one trace id (a contextvar, so it follows threads and async tasks whose
  context is copied)::

      with obs.span("train.step", step=i) as sp:
          state, loss = step_fn(state, batch)
          sp.fence(loss)          # waited for before the end stamp
          sp.set(loss=float(loss))

- :func:`traced` — decorator; fences the wrapped function's return value.
- :func:`timer` — :func:`span` that also feeds a histogram child or a
  :class:`.metrics.Rolling` with the fenced duration.
- :func:`start_span` / :meth:`Span.end` — a DETACHED span for work issued
  in one call frame and finished in another (the overlapped serving
  round): open at dispatch, :meth:`Span.mark` stamps ``<label>_s``
  offsets, ``end()`` fences and emits. A detached span never becomes the
  ambient parent.
- :class:`DeviceFence` — the overlapped round's asynchronous copy of its
  outputs to the host.

Every closed span emits one event (kind ``"span"``) to the default sink;
with the sink off the cost is two ``perf_counter`` calls and a dict.
"""
from __future__ import annotations

import contextvars
import functools
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..compat.torchapi import allow_transfer
from . import events

# Innermost open span of this context (None at top level).
_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "katatpu_current_span", default=None
)


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def current_span() -> Optional["Span"]:
    return _current.get()


def current_trace_id() -> Optional[str]:
    sp = _current.get()
    return sp.trace_id if sp is not None else None


def current_span_id() -> Optional[str]:
    sp = _current.get()
    return sp.span_id if sp is not None else None


def new_trace() -> str:
    """A fresh trace id, for callers that thread one across processes."""
    return _new_id(8)


def _cuda_tensors(value: Any, out: list) -> list:
    """The CUDA tensors in ``value`` (a tensor, or lists, tuples and dicts
    of them); everything else needs no fence."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.append(value)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_tensors(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_tensors(v, out)
    return out


def device_fence(value: Any) -> None:
    """Wait until the work that produces every CUDA tensor in ``value`` is
    done: one event recorded on the current stream of each device involved,
    and synchronized. A no-op for host values and inside a CUDA-graph
    capture."""
    devices = {t.device for t in _cuda_tensors(value, [])}
    if not devices or torch.cuda.is_current_stream_capturing():
        return
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class Span:
    """One timed region. Mutable while open: ``set()`` attaches attributes,
    ``fence()`` registers values to wait for at exit. Closed spans carry
    ``duration_s`` and have been emitted to the event sink."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "attrs",
        "duration_s", "_fence", "_t0", "_token",
    )

    def __init__(self, name: str, parent: Optional["Span"] = None,
                 trace_id: Optional[str] = None, **attrs):
        self.name = name
        self.trace_id = (
            trace_id
            or (parent.trace_id if parent is not None else None)
            or _new_id(8)
        )
        self.span_id = _new_id(4)
        self.parent_id = parent.span_id if parent is not None else None
        self.attrs: dict = dict(attrs)
        self.duration_s: Optional[float] = None
        self._fence: list = []
        self._t0: Optional[float] = None
        self._token = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def fence(self, value: Any) -> Any:
        """Register ``value`` (tensors, or containers of them) to wait for
        at span exit; returns it unchanged."""
        self._fence.append(value)
        return value

    def mark(self, label: str) -> float:
        """Attach ``<label>_s`` = seconds since the span opened (e.g. the
        dispatch cost of an overlapped region, apart from its full
        dispatch-to-fence ``dur_s``)."""
        offset = time.perf_counter() - (self._t0 or 0.0)
        self.attrs[f"{label}_s"] = round(offset, 6)
        return offset

    def end(self, fence: Any = None) -> "Span":
        """Close a DETACHED span (:func:`start_span`): fence, stamp
        ``dur_s``, emit. Call once."""
        if fence is not None:
            self._fence.append(fence)
        err = self._close(None)
        if err is not None:
            raise err
        return self

    def _open(self) -> "Span":
        self._token = _current.set(self)
        self._t0 = time.perf_counter()
        return self

    def _close(self, error: Optional[BaseException]) -> Optional[BaseException]:
        # Fence BEFORE the end stamp. A failure the fence surfaces (a
        # device fault) propagates when the body succeeded and never masks
        # the body's own error.
        fence_error: Optional[BaseException] = None
        for value in self._fence:
            try:
                device_fence(value)
            except BaseException as e:
                fence_error = fence_error or e
        self.duration_s = time.perf_counter() - (self._t0 or 0.0)
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        payload = dict(self.attrs)
        error = error or fence_error
        if error is not None:
            payload["error"] = f"{type(error).__name__}: {error}"[:200]
        # A span that knows its token count reports tokens/s itself, so no
        # consumer divides by an unfenced time.
        tokens = payload.get("tokens")
        if isinstance(tokens, (int, float)) and self.duration_s > 0:
            payload["tokens_per_s"] = round(tokens / self.duration_s, 2)
        events.emit(
            "span", self.name, trace=self.trace_id, span=self.span_id,
            parent=self.parent_id, dur_s=round(self.duration_s, 6), **payload,
        )
        return fence_error


@contextmanager
def span(name: str, fence: Any = None, trace_id: Optional[str] = None,
         **attrs):
    """Open a span named ``name`` (module doc). ``fence`` registers a value
    (or a zero-argument callable resolved at exit) to wait for;
    ``Span.fence()`` registers more from inside the block."""
    sp = Span(name, parent=_current.get(), trace_id=trace_id, **attrs)
    sp._open()
    error: Optional[BaseException] = None
    try:
        yield sp
    except BaseException as e:
        error = e
        raise
    finally:
        # The up-front fence resolves on the success path only; a raising
        # resolver still closes the span, or every later span would
        # inherit a dead parent.
        resolver_error: Optional[BaseException] = None
        if fence is not None and error is None:
            try:
                sp._fence.append(fence() if callable(fence) else fence)
            except BaseException as e:
                resolver_error = e
        fence_error = sp._close(error or resolver_error)
        if error is None:
            if resolver_error is not None:
                raise resolver_error
            if fence_error is not None:
                raise fence_error


@contextmanager
def timer(name: str, metric: Any = None, fence: Any = None, **attrs):
    """:func:`span` that also feeds ``metric`` (a histogram or gauge child,
    ``.observe``/``.set``, or a :class:`.metrics.Rolling`) with the fenced
    duration."""
    with span(name, fence=fence, **attrs) as sp:
        yield sp
    if metric is not None:
        observe = getattr(metric, "observe", None) or getattr(metric, "set", None)
        if observe is not None:
            observe(sp.duration_s)


def start_span(name: str, trace_id: Optional[str] = None, **attrs) -> Span:
    """Open a DETACHED span: timing starts now, but spans opened while it is
    in flight do not become its children, and closing it from a later call
    frame cannot unwind anyone's parent. It still records the ambient span
    at open as its parent; ``trace_id`` pins it to an existing trace::

        sp = obs.start_span("serving.decode_chunk", chunk_tokens=n)
        toks = dispatch(...)        # returns before the card is done
        sp.mark("dispatch")         # dispatch_s: the host-side cost
        ...
        sp.end(fence=toks)          # dur_s: dispatch to results ready
    """
    sp = Span(name, parent=_current.get(), trace_id=trace_id, **attrs)
    sp._t0 = time.perf_counter()
    return sp


class DeviceFence:
    """An in-flight device-to-host copy of named tensors.

    On CUDA, construction enqueues one ``non_blocking`` copy of each tensor
    into a pinned host buffer of its own on the current stream, behind the
    work that produces it, then records an event; :meth:`wait` synchronizes
    that event only, so the work enqueued after the fence keeps running.
    The buffers belong to the fence: a later fence's copy never lands in a
    buffer this one has not handed over yet. On the CPU the copy is plain
    and already complete."""

    __slots__ = ("_bufs", "_event")

    def __init__(self, **tensors: torch.Tensor):
        self._event = None
        self._bufs = {}
        for name, t in tensors.items():
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
            else:
                buf = t.clone()
            self._bufs[name] = buf
        if any(t.is_cuda for t in tensors.values()):
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> dict[str, np.ndarray]:
        """Block until every copy has landed; ``{name: np.ndarray}``, each
        the caller's own. Strict mode's sanctioned retire point
        (:func:`..compat.torchapi.allow_transfer`)."""
        if self._event is not None:
            with allow_transfer("DeviceFence retire: the async copy lands here"):
                self._event.synchronize()
        return {k: b.numpy().copy() for k, b in self._bufs.items()}


def traced(name: Optional[str] = None, fence_result: bool = True) -> Callable:
    """Decorator form: the whole call is one span; the return value is
    fenced before the end stamp unless ``fence_result=False``."""

    def deco(fn: Callable) -> Callable:
        span_name = name or f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(span_name) as sp:
                result = fn(*args, **kwargs)
                if fence_result:
                    sp.fence(result)
                return result

        return wrapper

    return deco
