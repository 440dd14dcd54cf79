"""The train step on one device: AdamW as optax applies it, and
``make_train_step`` (counterpart of ``make_optimizer`` and
``make_train_step`` in ``kata_xpu_device_plugin_tpu/parallel/sharding.py``,
without the mesh: FSDP, tensor and sequence parallelism are not ported
yet).

The step contract is the JAX package's: ``init_state(seed)`` returns
``{"params", "opt", "step"}`` and ``step(state, tokens)`` returns
``(state, loss)``, or ``(state, loss, {"grad_norm"})`` with
``aux_metrics=True``. Unlike the JAX step, which donates its state and
returns a new one, the PyTorch step updates the parameters and the
optimizer moments IN PLACE (no second copy of a 16-bytes-a-parameter
state) and returns the same dict.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import transformer as tfm


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in a fixed (sorted-key) order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def _rebuild(tree, flat: list[torch.Tensor]):
    """A nested dict of the same shape as ``tree`` over ``flat``'s tensors."""
    it = iter(flat)

    def node(t):
        if isinstance(t, dict):
            return {k: node(t[k]) for k in sorted(t)}
        return next(it)

    return node(tree)


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors, fp32 (``optax.global_norm``)."""
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]
                       ).square().sum().sqrt()


class AdamW:
    """``optax.adamw(schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay)``,
    optionally after ``optax.clip_by_global_norm``, updating in place.

    What optax does, matched here: the schedule is read at the step count
    BEFORE its increment (a warmup schedule's first update has lr 0 and
    only moves the moments); the bias corrections use the count after it;
    weight decay is added to the Adam direction for every leaf (no mask);
    clipping scales by ``max_norm / norm`` with no epsilon, and only when
    ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` would add
    1e-6 to the norm and always scale)."""

    b1, b2, eps = 0.9, 0.95, 1e-8

    def __init__(self, lr: float = 3e-4, weight_decay: float = 0.01,
                 warmup_steps: int = 0, total_steps: int = 0,
                 min_lr_ratio: float = 0.1, grad_clip: float = 0.0):
        if total_steps and total_steps <= warmup_steps:
            raise ValueError(f"total_steps {total_steps} must exceed "
                             f"warmup_steps {warmup_steps}")
        self.lr, self.weight_decay = lr, weight_decay
        self.warmup_steps, self.total_steps = warmup_steps, total_steps
        self.min_lr_ratio, self.grad_clip = min_lr_ratio, grad_clip

    def learning_rate(self, count: int) -> float:
        """``optax.warmup_cosine_decay_schedule(0, lr, warmup, total,
        lr * min_lr_ratio)`` at ``count`` when ``total_steps > 0``, else
        the constant ``lr``."""
        if not self.total_steps:
            return self.lr
        if count < self.warmup_steps:  # linear 0 -> lr
            return self.lr * count / self.warmup_steps
        alpha = self.min_lr_ratio
        decay_steps = self.total_steps - self.warmup_steps
        t = min(count - self.warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return self.lr * ((1.0 - alpha) * cosine + alpha)

    def init(self, params) -> dict:
        return {
            "count": 0,
            "mu": _rebuild(params, [torch.zeros_like(p) for p in leaves(params)]),
            "nu": _rebuild(params, [torch.zeros_like(p) for p in leaves(params)]),
        }

    def clip(self, grads: list[torch.Tensor]) -> None:
        """``optax.clip_by_global_norm(grad_clip)`` in place, without a
        host sync: ``g / norm * max_norm`` when ``norm >= max_norm``."""
        if self.grad_clip <= 0.0:
            return
        norm = global_norm(grads)
        keep = norm < self.grad_clip
        div = torch.where(keep, torch.ones_like(norm), norm)
        mul = torch.where(keep, torch.ones_like(norm),
                          torch.full_like(norm, self.grad_clip))
        for g in grads:
            g.div_(div).mul_(mul)

    @torch.no_grad()
    def update(self, params, grads: list[torch.Tensor], state: dict) -> None:
        """One AdamW step of ``params`` (in place) from ``grads`` (in the
        order of :func:`leaves`; consumed as scratch)."""
        self.clip(grads)
        lr = self.learning_rate(state["count"])
        state["count"] += 1
        t = state["count"]
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for p, g, mu, nu in zip(leaves(params), grads, leaves(state["mu"]),
                                leaves(state["nu"])):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            den = torch.div(nu, bc2, out=g).sqrt_().add_(self.eps)
            upd = torch.div(mu, bc1).div_(den)
            upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 0, total_steps: int = 0,
                   min_lr_ratio: float = 0.1, grad_clip: float = 0.0) -> AdamW:
    """AdamW with the standard LLM-training extras, all opt-in (the JAX
    package's defaults and meaning):

    - ``total_steps > 0``: linear warmup over ``warmup_steps`` then cosine
      decay to ``lr · min_lr_ratio`` at ``total_steps``; otherwise
      constant ``lr``.
    - ``grad_clip > 0``: global-norm gradient clipping before the update.
    """
    return AdamW(lr, weight_decay, warmup_steps, total_steps, min_lr_ratio,
                 grad_clip)


def make_train_step(cfg: tfm.DecoderConfig, optimizer: Optional[AdamW] = None,
                    attn_fn: Optional[Callable] = None, remat: bool = False,
                    accum_steps: int = 1, aux_metrics: bool = False,
                    device=None):
    """Returns ``(init_state, step)`` for one device (CUDA unless
    ``device`` says otherwise; without CUDA and without ``device`` it
    raises). Parameters are fp32 (``init_params(..., dtype=float32)``, as
    ``init_sharded_params`` keeps them) and the forward computes in
    ``cfg.dtype``; ``attn_fn`` defaults to ``flash_attention`` — the
    kernels on the card, the plain version on the CPU.

    ``accum_steps > 1`` splits ``tokens [accum_steps·B, S]`` into equal
    microbatches, one live at a time, and applies the mean of their
    gradients (and losses) in one update. ``aux_metrics=True`` also
    returns ``{"grad_norm"}``, the global norm of the (unclipped) mean
    gradient. The loss and the norm stay device scalars: the step never
    syncs with the host."""
    optimizer = optimizer or make_optimizer()
    device = resolve_device(device)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def init_state(seed: int = 0) -> dict:
        params = tfm.init_params(cfg, seed=seed, device=device,
                                 dtype=torch.float32)
        return {"params": params, "opt": optimizer.init(params), "step": 0}

    def step(state: dict, tokens):
        tokens = torch.as_tensor(np.asarray(tokens), device=device).long()
        if tokens.shape[0] % accum_steps:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"accum_steps={accum_steps}")
        params = state["params"]
        # Gradients are taken against detached aliases of the parameters,
        # so the state's tensors never require grad and update in place.
        xs = [p.detach().requires_grad_() for p in leaves(params)]
        view = _rebuild(params, xs)
        grads, loss = None, None
        with torch.enable_grad():
            for mb in tokens.chunk(accum_steps):
                lm = tfm.next_token_loss(view, mb, cfg, attn_fn=attn_fn,
                                         remat=remat)
                gm = torch.autograd.grad(lm, xs)
                lm = lm.detach()
                if grads is None:
                    grads, loss = list(gm), lm
                else:
                    for g, x in zip(grads, gm):
                        g.add_(x)
                    loss = loss + lm
        if accum_steps > 1:
            for g in grads:
                g.div_(accum_steps)
            loss = loss / accum_steps
        aux = {"grad_norm": global_norm(grads)} if aux_metrics else None
        optimizer.update(params, grads, state["opt"])
        state["step"] += 1
        return (state, loss, aux) if aux_metrics else (state, loss)

    return init_state, step
