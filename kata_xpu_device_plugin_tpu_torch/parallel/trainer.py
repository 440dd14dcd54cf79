"""The training loop: loader → train step → checkpoint/resume, as one call
(counterpart of ``fit`` in ``kata_xpu_device_plugin_tpu/parallel/trainer.py``).

A preempted-and-resumed run replays the uninterrupted one exactly — same
batches, same losses, bit-identical state — because the loader cursor is
saved next to the train state and both restore together. With the event
sink on, each step is a ``train.step`` span fenced on its loss, feeding
the ``kata_tpu_train_*`` metrics, as in the JAX package. Over a process
mesh every rank runs the loop and saves its pieces; rank 0 alone emits the
events and metrics and writes the loader cursors.
"""
from __future__ import annotations

import json
import logging
import math
import os
from typing import Any, Callable, Optional

from .. import obs
from .checkpoint import TrainCheckpointer
from .loader import TokenBatchLoader
from .mesh import Mesh, is_process_mesh

LOG = logging.getLogger(__name__)

# The JAX trainer's metrics, through the idempotent factory: two fit()
# calls share one set.
_step_seconds = obs.histogram("kata_tpu_train_step_seconds",
                              "Optimizer-step wall time (fenced)")
_loss_gauge = obs.gauge("kata_tpu_train_loss", "Last training loss")
_tokens_per_s = obs.gauge("kata_tpu_train_tokens_per_s",
                          "Training throughput, last step")
_grad_norm_gauge = obs.gauge("kata_tpu_train_grad_norm",
                             "Global gradient norm, last step")


def _cursor_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"loader_{step}.json")


def fit(init_state: Callable, step_fn: Callable, loader: TokenBatchLoader,
        steps: int, seed: int = 0, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0, log_every: int = 0,
        on_step: Optional[Callable] = None,
        profiler: Optional[obs.ProfilerHook] = None,
        mesh: Optional[Mesh] = None) -> tuple[Any, list]:
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
    which syncs with the device on those steps only.

    Telemetry: with the event sink on (``KATATPU_OBS=1``), every step runs
    inside a ``train.step`` span that fences on the loss (an event on the
    step's stream), so the step time covers the device work, and the span,
    the sink and the ``kata_tpu_train_*`` metrics get the step time, loss,
    tokens/s and (when the step reports it) the gradient norm; after two
    or more steps one ``derived``/``train.compile_estimate`` event splits
    the first step's one-time cost from the steady state. That path waits
    for every step by design; without a sink the loop is as before.
    ``profiler`` (default: from ``KATATPU_OBS_PROFILE_DIR``) traces the
    configured window of steps.

    ``mesh``: the process mesh ``step_fn`` runs over
    (:func:`.mesh.process_mesh`), whose every rank calls ``fit`` with a
    loader of its own rows (:func:`.loader.make_loader` under the mesh).
    Each rank saves its pieces of the checkpoint; rank 0 alone writes the
    cursors, logs, traces and emits the telemetry (every rank's loss is the
    same global mean)."""
    if ckpt_every and not ckpt_dir:
        raise ValueError("ckpt_every needs ckpt_dir")
    lead = not is_process_mesh(mesh) or mesh.rank == 0
    if profiler is None and lead:
        profiler = obs.profiler_from_env()
    state = init_state(seed)
    ckpt: Optional[TrainCheckpointer] = None
    start = 0
    if ckpt_dir:
        ckpt = TrainCheckpointer(ckpt_dir, mesh=mesh)
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(state, step=latest)
            with open(_cursor_path(ckpt_dir, latest)) as f:
                loader.load_state_dict(json.load(f))
            start = latest
            LOG.info("resumed at step %d from %s", latest, ckpt_dir)
    instrument = lead and obs.default_sink() is not None
    step_durs: list[float] = []
    losses: list = []
    try:
        if profiler is not None:
            # Primed with the step resumed from, so a window from step 1,
            # or one a resume lands inside, still opens.
            profiler.on_step(start)
        for s in range(start, steps):
            batch = next(loader)
            if instrument:
                state, loss = _instrumented_step(step_fn, state, batch, s + 1,
                                                 s == start, step_durs)
            else:
                state, loss = step_fn(state, batch)[:2]
            if lead and log_every and (s + 1) % log_every == 0:
                LOG.info("step %d loss %.6f", s + 1, float(loss))  # torchguard: allow(TG101) log_every-gated: logging a loss forces its read by design
            if on_step is not None:
                on_step(s + 1, loss)
            losses.append(loss)
            if profiler is not None:
                profiler.on_step(s + 1)
            if ckpt is not None and ckpt_every and (s + 1) % ckpt_every == 0:
                # Cursor first, then the state: a kill between the two
                # leaves the previous step latest, with its cursor intact.
                if lead:
                    with open(_cursor_path(ckpt_dir, s + 1), "w") as f:
                        json.dump(loader.state_dict(), f)
                ckpt.save(s + 1, state)
                if lead:
                    _prune_cursors(ckpt_dir, ckpt.steps())
    finally:
        if profiler is not None:
            profiler.stop()
        if ckpt is not None:
            ckpt.wait()
            ckpt.close()
    if instrument and len(step_durs) >= 2:
        # The first step pays one-time costs (kernel builds, the allocator's
        # first requests) on top of one step; the steady minimum is a step
        # alone. Derived, not measured, and named so.
        steady = min(step_durs[1:])
        obs.emit("derived", "train.compile_estimate",
                 dur_s=round(max(0.0, step_durs[0] - steady), 6),
                 first_step_s=round(step_durs[0], 6),
                 steady_step_s=round(steady, 6))
    return state, [float(x) for x in losses]  # torchguard: allow(TG101) end-of-run conversion, after the loop


def _instrumented_step(step_fn, state, batch, step_num: int, first: bool,
                       step_durs: list):
    """One step in a ``train.step`` span fenced on the loss (the step's
    last output, ready only when the step is), feeding the span, the sink
    and the ``kata_tpu_train_*`` metrics."""
    shape = getattr(batch, "shape", None)
    tokens = int(math.prod(shape)) if shape else None
    attrs = {"step": step_num}
    if tokens:
        attrs["tokens"] = tokens
    if first:
        attrs["includes_compile"] = True
    with obs.span("train.step", **attrs) as sp:
        out = step_fn(state, batch)
        state, loss = out[:2]
        aux = dict(out[2]) if len(out) == 3 else {}
        sp.fence(loss)
        loss_val = float(loss)  # torchguard: allow(TG101) instrumented step syncs by design (honest step times)
        sp.set(loss=round(loss_val, 6))
        grad_norm = aux.get("grad_norm")
        if grad_norm is not None:
            grad_norm = float(grad_norm)
            sp.set(grad_norm=round(grad_norm, 6))
    step_durs.append(sp.duration_s)
    _step_seconds.observe(sp.duration_s)
    _loss_gauge.set(loss_val)
    if tokens and sp.duration_s > 0:
        _tokens_per_s.set(tokens / sp.duration_s)
    if grad_norm is not None:
        _grad_norm_gauge.set(grad_norm)
    return state, loss


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
