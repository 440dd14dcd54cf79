"""The device-to-host fence of overlapped serving (counterpart of
``DeviceFence`` in ``kata_xpu_device_plugin_tpu/obs/trace.py``)."""
from __future__ import annotations

import numpy as np
import torch


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
        the caller's own."""
        if self._event is not None:
            self._event.synchronize()
        return {k: b.numpy().copy() for k, b in self._bufs.items()}
