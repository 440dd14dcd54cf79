"""Pipeline parallelism: a GPipe microbatch schedule over a ``pipe`` mesh
axis (counterpart of ``kata_xpu_device_plugin_tpu/parallel/pipeline.py``).

Stage ``s`` holds slice ``s`` of the stacked stage parameters. Microbatch
``m`` enters stage 0 at tick ``m``, moves one stage a tick (the hop is
``collectives.ppermute``) and leaves stage ``P - 1`` at tick ``m + P -
1``: a run of ``M`` microbatches takes ``M + P - 1`` ticks. JAX's
schedule is one ``fori_loop`` in which every stage computes at every tick,
the bubble ticks on don't-care values that reach no output (and so get a
zero gradient). Every stage here is on one device and runs in turn, so a
bubble tick is skipped instead, as the ring skips the blocks above its
causal frontier: a run makes exactly ``M x P`` stage calls.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from ..ops import collectives
from .mesh import AXIS_PIPE, Mesh, pipe_mesh  # noqa: F401 (re-exported)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_stage_params(stage_params: Sequence[Any]) -> Any:
    """Per-stage parameter trees stacked on a new leading axis, the axis a
    pipeline cuts over ``pipe``."""
    return _tree_map(lambda *ls: torch.stack(ls), *stage_params)


def make_pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  num_stages: int, mesh: Mesh, axis: str = AXIS_PIPE):
    """``pipelined(stacked_params, microbatches) -> outputs``: ``stage_fn
    (params, x) -> y`` keeps ``x``'s shape; ``microbatches [M, mb, ...]``
    come back transformed by all ``num_stages`` stages in order (each
    stage's slice of ``stacked_params``, leading axis ``num_stages``)."""
    if mesh.shape[axis] != num_stages:
        raise ValueError(
            f"mesh axis {axis!r} has {mesh.shape[axis]} devices, want {num_stages}")

    def pipelined(stacked_params: Any, mbs: torch.Tensor) -> torch.Tensor:
        stages = [_tree_map(lambda p, s=s: p[s], stacked_params)
                  for s in range(num_stages)]
        num_mb = mbs.shape[0]
        held = [None] * num_stages  # the activation each stage holds
        outputs = [None] * num_mb
        for t in range(num_mb + num_stages - 1):
            ys = []
            for s in range(num_stages):
                m = t - s  # the microbatch at stage s this tick
                if not 0 <= m < num_mb:
                    ys.append(None)  # a bubble: no stage call
                    continue
                ys.append(stage_fn(stages[s], mbs[m] if s == 0 else held[s]))
            if ys[-1] is not None:
                outputs[t - (num_stages - 1)] = ys[-1]
            held = collectives.ppermute(ys)  # every stage to the next
        return torch.stack(outputs)

    return pipelined


def _check_uniform(cfg) -> None:
    if cfg.attn_windows or cfg.rope_theta_cycle or cfg.rope_linear_cycle:
        raise ValueError(
            "pipeline stages apply one uniform attention window and rope; "
            "per-layer attn_windows / rope cycles (Gemma-2/3 style) are "
            "not supported here")


def transformer_stage_fn(cfg, attn_fn: Optional[Callable] = None,
                         mesh: Optional[Mesh] = None):
    """One pipeline stage of a decoder: its ``[L_stage, ...]`` stacked
    layers over ``[B, S, D]`` activations (:func:`.spmd.run_layers`).
    Shared by the 1-D pipeline (whole layers) and the composed step
    (``mesh``: the stage's layers are pieces over its fsdp and model
    axes). ``attn_fn`` defaults to ``flash_attention`` (the kernels on the
    card, the plain version on the CPU; JAX's default is its XLA
    reference)."""
    from .spmd import model_size, run_layers

    tp = model_size(mesh) if mesh is not None else 1
    if getattr(cfg, "moe", False):
        raise ValueError(
            "pipeline stages do not thread the MoE aux loss yet; "
            "use the unpipelined make_train_step for MoE configs")
    if attn_fn is None:
        from ..ops.attention import flash_attention

        attn_fn = flash_attention

    def stage_fn(stage_layers: Any, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        return run_layers(stage_layers, x, cfg, tp, attn_fn, positions)[0]

    return stage_fn


def make_transformer_pipeline(cfg, n_stages: int, mesh: Mesh,
                              axis: str = AXIS_PIPE,
                              attn_fn: Optional[Callable] = None):
    """The pipelined decoder forward: the ``cfg.n_layers`` blocks split
    into ``n_stages`` contiguous chunks, one a stage; the embedding, final
    norm and unembedding run outside the pipeline. Returns
    ``pipelined_forward(params, tokens_mb [M, mb, S]) -> logits [M, mb, S,
    vocab]``, per microbatch equal to ``models.transformer.forward``."""
    from ..models import transformer as tfm

    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by {n_stages} stages")
    _check_uniform(cfg)
    per_stage = cfg.n_layers // n_stages
    pipe = make_pipeline(transformer_stage_fn(cfg, attn_fn), n_stages, mesh,
                         axis)

    def pipelined_forward(params: Any, tokens_mb: torch.Tensor) -> torch.Tensor:
        x = tfm.embed(params, tokens_mb, cfg)  # [M, mb, S, D]
        stage_layers = _tree_map(
            lambda a: a.reshape((n_stages, per_stage) + a.shape[1:]),
            params["layers"])
        return tfm.unembed(params, pipe(stage_layers, x), cfg)

    return pipelined_forward


def sequential_reference(stage_fn: Callable, stage_params: Sequence[Any],
                         mbs: torch.Tensor) -> torch.Tensor:
    """What the pipeline must equal: every microbatch through every stage."""
    out = mbs
    for params in stage_params:
        out = torch.stack([stage_fn(params, x) for x in out])
    return out
