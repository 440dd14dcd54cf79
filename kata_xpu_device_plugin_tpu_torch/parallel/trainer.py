"""The training loop: loader → train step → checkpoint/resume, as one call
(counterpart of ``fit`` in ``kata_xpu_device_plugin_tpu/parallel/trainer.py``).

A preempted-and-resumed run replays the uninterrupted one exactly — same
batches, same losses, bit-identical state — because the loader cursor is
saved next to the train state and both restore together. The JAX
package's telemetry (``obs`` spans and gauges) and profiler hook are not
ported yet.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Optional

from .checkpoint import TrainCheckpointer
from .loader import TokenBatchLoader

LOG = logging.getLogger(__name__)


def _cursor_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"loader_{step}.json")


def fit(init_state: Callable, step_fn: Callable, loader: TokenBatchLoader,
        steps: int, seed: int = 0, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0, log_every: int = 0,
        on_step: Optional[Callable] = None) -> tuple[Any, list]:
    """Train for ``steps`` optimizer steps; returns ``(state, losses)``
    with the losses as floats.

    ``init_state``/``step_fn`` are :func:`.sharding.make_train_step`'s pair
    (a ``step_fn`` may also return ``(state, loss, aux)``). With
    ``ckpt_dir``:

    - every ``ckpt_every`` steps the loader cursor and then the train
      state are written (the newest three kept, stale cursors pruned);
    - on startup, if a checkpoint exists, both restore and training
      continues at the batch the interrupted run would have drawn next.

    ``on_step(step, loss)`` is a host callback (metrics, early stop by
    raising; ``loss`` is a device scalar); ``log_every`` logs the loss,
    which syncs with the device on those steps only."""
    if ckpt_every and not ckpt_dir:
        raise ValueError("ckpt_every needs ckpt_dir")
    state = init_state(seed)
    ckpt: Optional[TrainCheckpointer] = None
    start = 0
    if ckpt_dir:
        ckpt = TrainCheckpointer(ckpt_dir)
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(state, step=latest)
            with open(_cursor_path(ckpt_dir, latest)) as f:
                loader.load_state_dict(json.load(f))
            start = latest
            LOG.info("resumed at step %d from %s", latest, ckpt_dir)
    losses: list = []
    try:
        for s in range(start, steps):
            state, loss = step_fn(state, next(loader))[:2]
            if log_every and (s + 1) % log_every == 0:
                LOG.info("step %d loss %.6f", s + 1, float(loss))
            if on_step is not None:
                on_step(s + 1, loss)
            losses.append(loss)
            if ckpt is not None and ckpt_every and (s + 1) % ckpt_every == 0:
                # Cursor first, then the state: a kill between the two
                # leaves the previous step latest, with its cursor intact.
                with open(_cursor_path(ckpt_dir, s + 1), "w") as f:
                    json.dump(loader.state_dict(), f)
                ckpt.save(s + 1, state)
                _prune_cursors(ckpt_dir, ckpt.steps())
    finally:
        if ckpt is not None:
            ckpt.wait()
            ckpt.close()
    return state, [float(x) for x in losses]


def _prune_cursors(directory: str, live_steps) -> None:
    """Drop ``loader_*.json`` cursors whose checkpoint was pruned."""
    live = {int(s) for s in live_steps}
    directory = os.path.abspath(directory)
    for name in os.listdir(directory):
        if name.startswith("loader_") and name.endswith(".json"):
            try:
                step = int(name[len("loader_"): -len(".json")])
            except ValueError:
                continue
            if step not in live:
                os.unlink(os.path.join(directory, name))
