"""Train-state checkpoints for one device (counterpart of
``TrainCheckpointer`` in ``kata_xpu_device_plugin_tpu/parallel/checkpoint.py``,
on ``torch.save``/``torch.load`` instead of orbax; the sharded form waits
for the FSDP slice).

One file per step, ``step_<n>.pt`` in one directory. A write goes to a
temporary file that is renamed into place only when complete, so a kill
mid-save leaves the previous step as ``latest``. Writes are synchronous:
:meth:`TrainCheckpointer.wait` and :meth:`TrainCheckpointer.close` are
no-ops kept for the JAX package's call pattern.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

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
        torch.save(state, tmp)
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


def _fill(live: Any, saved: Any, path: str) -> Any:
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(f"checkpoint tree differs from the state at {path}")
        return {k: _fill(live[k], saved[k], f"{path}.{k}") for k in live}
    if isinstance(live, torch.Tensor):
        if (not isinstance(saved, torch.Tensor) or saved.shape != live.shape
                or saved.dtype != live.dtype):
            raise ValueError(f"checkpoint tensor differs from the state at {path}")
        with torch.no_grad():
            live.copy_(saved)
        return live
    return saved
