"""Composed parallelism: pipeline x FSDP x tensor parallelism on one mesh
(counterpart of ``kata_xpu_device_plugin_tpu/parallel/composed.py``).

The stage-major layers are cut over ``pipe`` and, inside a stage, over
``fsdp`` and ``model`` by :data:`.sharding.PARAM_RULES`; the embedding and
norms keep their rules (whole over ``pipe``). Microbatches are owned per
stage: stage ``s`` holds block ``s`` of ``M/P`` microbatches, embeds its
own microbatch when the schedule reaches it and routes it to stage 0;
stage ``P - 1`` routes each finished activation back to its owner, which
unembeds it and sums its nll. No stage holds all ``M`` microbatches'
activations or any ``[mb, S, vocab]`` row of logits gathered over the
model shards (the vocab-parallel cross-entropy of :mod:`.spmd`).

Inside a stage the layers run the sharded layer program of the flat step
(:func:`.spmd.run_layers`: gathers over fsdp, column- and row-parallel
products over model, the attention per local block). Every stage is on
the mesh's one device: the schedule's hops are list moves, the bubble
ticks are skipped (:mod:`.pipeline`), and autograd carries the gradients
back through the schedule (the transpose of a hop is the reverse hop,
which costs nothing here).

A port difference: JAX embeds ``tokens[..., :-1]``; here the stages run
the full ``S`` positions and the last one's output is dropped before the
loss, as ``models.transformer.next_token_loss`` does (value-identical
under the causal mask; the pipeline refuses MoE configs, the one case
where the last token would count), so a flash-length batch stays one.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..models import transformer as tfm
from ..ops import collectives
from . import spmd
from .mesh import AXIS_PIPE, Mesh, composed_mesh  # noqa: F401 (re-exported)
from .pipeline import _check_uniform, _tree_map, transformer_stage_fn
from .sharding import (
    PARAM_RULES,
    AdamW,
    Layout,
    Sharded,
    _rebuild,
    _tokens_on,
    _tree_paths,
    leaves,
    make_optimizer,
    mesh_attention,
)

def pp_param_spec(path: str) -> tuple:
    """The stage-major layout's spec: layer-stacked leaves gain a leading
    stage axis cut over ``pipe`` in front of their rule; the rest keep
    theirs."""
    rule = PARAM_RULES[path]
    if path.startswith("layers."):
        return (AXIS_PIPE, *rule)
    return rule


def to_pp_params(params: Any, n_stages: int) -> Any:
    """``[L, ...]`` layers as ``[P, L/P, ...]`` stage-major views: stage s
    holds layers ``[s·L/P, (s+1)·L/P)``."""
    out = dict(params)
    out["layers"] = _tree_map(
        lambda a: a.reshape((n_stages, a.shape[0] // n_stages) + a.shape[1:]),
        params["layers"])
    return out


def pp_param_shardings(params_pp: Any, mesh: Mesh) -> Any:
    """The :class:`.sharding.Layout` of every leaf of a stage-major tree."""
    return _tree_map(lambda path: Layout(pp_param_spec(path), mesh),
                     _tree_paths(params_pp))


def init_pp_params(cfg: tfm.DecoderConfig, mesh: Mesh, n_stages: int,
                   seed: int = 0, dtype=torch.float32) -> Any:
    """``to_pp_params(init_params(cfg, seed=seed))``'s values, born in the
    stage-major sharded layout: each leaf is cut as soon as it is drawn."""
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by {n_stages}")

    def place(path: str, t: torch.Tensor):
        if path.startswith("layers."):
            t = t.reshape((n_stages, t.shape[0] // n_stages) + t.shape[1:])
        return Layout(pp_param_spec(path), mesh).cut(t)

    return tfm.init_params(cfg, seed=seed, device=mesh.device, dtype=dtype,
                           place=place)


def _stage_leaf(leaf: Any, s: int) -> Any:
    if isinstance(leaf, Sharded):
        return leaf.stage(s)
    return leaf[s]


def make_pp_loss(cfg: tfm.DecoderConfig, mesh: Mesh, n_stages: int,
                 num_microbatches: int, attn_fn: Optional[Callable] = None):
    """``loss_fn(params_pp, tokens [M, mb, S]) -> scalar``, equal to
    ``models.transformer.next_token_loss`` on the flattened batch.
    ``attn_fn`` defaults to the mesh's (:func:`.sharding.mesh_attention`:
    the kernels per local block on the card, the plain path on the CPU)."""
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by {n_stages}")
    _check_uniform(cfg)
    if num_microbatches % n_stages:
        raise ValueError(
            f"num_microbatches={num_microbatches} not divisible by {n_stages} "
            "(each stage owns an equal block)")
    if mesh.shape.get(AXIS_PIPE, 1) != n_stages:
        raise ValueError(f"mesh axis {AXIS_PIPE!r} has "
                         f"{mesh.shape.get(AXIS_PIPE, 1)} devices, want {n_stages}")
    m_local = num_microbatches // n_stages
    if attn_fn is None:
        attn_fn = mesh_attention(cfg, mesh)
    stage_fn = transformer_stage_fn(cfg, attn_fn, mesh=mesh)
    tp = spmd.model_size(mesh)
    P, M = n_stages, num_microbatches

    def loss_fn(params_pp: Any, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.shape[0] != M:
            raise ValueError(f"tokens carry {tokens.shape[0]} microbatches, "
                             f"want {M}")
        stages = [_tree_map(lambda l, s=s: _stage_leaf(l, s), params_pp["layers"])
                  for s in range(P)]
        blocks = tokens.chunk(P, dim=0)  # stage s owns microbatches of block s
        outputs = [[None] * m_local for _ in range(P)]
        held = [None] * P
        for t in range(M + P - 1):
            ys = []
            for s in range(P):
                m = t - s
                if not 0 <= m < M:
                    ys.append(None)  # a bubble: skipped
                    continue
                if s == 0:  # ingest: the owner embeds, then hops to stage 0
                    owner, slot = divmod(m, m_local)
                    x = spmd.vocab_embed(params_pp["embed"], blocks[owner][slot],
                                         cfg, tp)
                else:
                    x = held[s]
                ys.append(stage_fn(stages[s], x))
            if ys[-1] is not None:  # egress: back to the microbatch's owner
                owner, slot = divmod(t - (P - 1), m_local)
                outputs[owner][slot] = ys[-1]
            held = collectives.ppermute(ys)  # stage 0 never reads its hop
        nll = []
        for s in range(P):  # each owner's loss over its own block
            x = torch.stack(outputs[s])  # [M/P, mb, S, d]
            nll.append(spmd.vocab_nll_sum(params_pp, x[:, :, :-1],
                                          blocks[s][:, :, 1:], cfg, tp))
        _, mb, S = tokens.shape
        total = nll[0]
        for v in nll[1:]:  # the sum over stages, in order
            total = total + v
        return total / (M * mb * (S - 1))

    return loss_fn


def make_pp_train_step(cfg: tfm.DecoderConfig, mesh: Mesh, n_stages: int,
                       num_microbatches: int,
                       optimizer: Optional[AdamW] = None,
                       attn_fn: Optional[Callable] = None):
    """The composed pp x fsdp x tp step: ``init_state(seed)`` draws
    ``init_params(cfg, seed=seed)``'s values into the stage-major pieces;
    ``step(state, tokens [M, mb, S]) -> (state, loss)`` updates them in
    place with AdamW, whose moments mirror the pieces."""
    optimizer = optimizer or make_optimizer()
    loss_fn = make_pp_loss(cfg, mesh, n_stages, num_microbatches, attn_fn)
    device = mesh.device

    def init_state(seed: int = 0) -> dict:
        params = init_pp_params(cfg, mesh, n_stages, seed=seed)
        return {"params": params, "opt": optimizer.init(params), "step": 0}

    def step(state: dict, tokens):
        tokens = _tokens_on(tokens, device)
        params = state["params"]
        xs = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_rebuild(params, xs), tokens)
            grads = list(torch.autograd.grad(loss, xs))
        optimizer.update(params, grads, state["opt"])
        state["step"] += 1
        return state, loss.detach()

    return init_state, step


def _pp_opt_shardings(optimizer: AdamW, params_pp: Any, mesh: Mesh) -> dict:
    """The moments mirror the stage-major pieces; the count is a host
    integer."""
    del optimizer
    layouts = pp_param_shardings(params_pp, mesh)
    return {"count": None, "mu": layouts, "nu": layouts}


def shard_microbatches(tokens, mesh: Mesh) -> torch.Tensor:
    """``[M, mb, S]`` tokens on the mesh's device as int64; stage s owns
    microbatch block s (``M/P`` of them), as the loss reads them."""
    return _tokens_on(tokens, mesh.device)

