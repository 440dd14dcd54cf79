"""Train-state checkpoints (counterpart of ``TrainCheckpointer`` in
``kata_xpu_device_plugin_tpu/parallel/checkpoint.py``, on
``torch.save``/``torch.load`` instead of orbax), whole or sharded.

One file per step, ``step_<n>.pt`` in one directory. A write goes to a
temporary file that is renamed into place only when complete, so a kill
mid-save leaves the previous step as ``latest``. Writes are synchronous:
:meth:`TrainCheckpointer.wait` and :meth:`TrainCheckpointer.close` are
no-ops kept for the JAX package's call pattern.

A sharded state (:class:`.sharding.Sharded` leaves, the LoRA and int8
wrappers) is written piece by piece, each piece its own tensor with its
spec and cuts beside it: no whole tensor is assembled to save. A restore
fills ``state_like``'s layout, as orbax's ``StandardRestore`` does: a leaf
saved with the same cuts is copied piece by piece (bit-equal), any other
is assembled from its saved pieces and cut into the live ones (the same
values under another mesh).
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

from .sharding import Sharded, cut_pieces

_NAME = re.compile(r"^step_(\d+)\.pt$")


class TrainCheckpointer:
    """Step-indexed checkpoints of a train state — any nest of dicts over
    tensors and Python scalars, e.g. ``{"params", "opt", "step"}`` from
    :func:`.sharding.make_train_step` — keeping the newest
    ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` at ``step`` atomically, then prune to
        ``max_to_keep``."""
        final = self._path(step)
        tmp = f"{final}.{os.getpid()}.tmp"
        torch.save(_encode(state), tmp)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def steps(self) -> list[int]:
        """All retained checkpoint steps, ascending."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """The checkpoint at ``step`` (default: the latest) read into
        ``state_like``'s tensors in place — same shapes, dtypes and devices,
        with no second device copy of the state — and returned with its
        scalars replaced. A mismatched tree or tensor raises."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        saved = torch.load(self._path(step), map_location="cpu", mmap=True,
                           weights_only=True)
        return _fill(state_like, saved, "state")

    def wait(self) -> None:
        """Writes are synchronous; nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


_SHARDED, _TUPLE = "__sharded__", "__tuple__"


def _encode(state: Any) -> Any:
    """The state as dicts, lists, tensors and scalars (what ``torch.load``
    reads with ``weights_only``): a Sharded leaf as its spec, cuts, shape
    and pieces; a wrapper as its fields."""
    if isinstance(state, dict):
        return {k: _encode(v) for k, v in state.items()}
    if isinstance(state, Sharded):
        return {_SHARDED: {"spec": list(state.spec), "cuts": list(state.cuts),
                           "shape": list(state.shape),
                           "pieces": list(state.pieces)}}
    if isinstance(state, tuple):
        return {_TUPLE: [_encode(v) for v in state]}
    return state


def _assemble(saved: dict) -> torch.Tensor:
    """The whole tensor of a saved Sharded leaf."""
    live = Sharded(saved["spec"], saved["cuts"], saved["pieces"], saved["shape"])
    return live.select()


def _fill(live: Any, saved: Any, path: str) -> Any:
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(f"checkpoint tree differs from the state at {path}")
        return {k: _fill(live[k], saved[k], f"{path}.{k}") for k in live}
    if isinstance(live, tuple):
        if not (isinstance(saved, dict) and _TUPLE in saved
                and len(saved[_TUPLE]) == len(live)):
            raise ValueError(f"checkpoint tree differs from the state at {path}")
        return type(live)(*(_fill(a, b, f"{path}[{i}]")
                            for i, (a, b) in enumerate(zip(live, saved[_TUPLE]))))
    sharded = isinstance(saved, dict) and _SHARDED in saved
    if isinstance(live, Sharded):
        if sharded and (tuple(saved[_SHARDED]["cuts"]) == live.cuts
                        and tuple(saved[_SHARDED]["shape"]) == live.shape):
            pieces = saved[_SHARDED]["pieces"]  # the same cut: piece by piece
        else:
            whole = _assemble(saved[_SHARDED]) if sharded else saved
            _check(whole, live.shape, live.dtype, path)
            pieces = cut_pieces(whole, live.cuts)
        for i, (p, q) in enumerate(zip(live.pieces, pieces)):
            _check(q, p.shape, p.dtype, f"{path}#{i}")
            with torch.no_grad():
                p.copy_(q)
        return live
    if isinstance(live, torch.Tensor):
        saved = _assemble(saved[_SHARDED]) if sharded else saved
        _check(saved, live.shape, live.dtype, path)
        with torch.no_grad():
            live.copy_(saved)
        return live
    return saved


def _check(saved: Any, shape, dtype, path: str) -> None:
    if (not isinstance(saved, torch.Tensor) or saved.shape != shape
            or saved.dtype != dtype):
        raise ValueError(f"checkpoint tensor differs from the state at {path}")
