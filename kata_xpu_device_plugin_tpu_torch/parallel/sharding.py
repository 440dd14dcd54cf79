"""The train step: AdamW as optax applies it, and ``make_train_step``
(counterpart of ``make_optimizer``, ``make_train_step``, ``batch_spec``
and ``shard_batch`` in ``kata_xpu_device_plugin_tpu/parallel/sharding.py``)
on one device, optionally over a mesh with a ``seq`` axis (sequence
parallelism: ring attention by default, every shard on the mesh's device,
:mod:`.mesh`); FSDP, tensor and data parallelism for training are not
ported yet. And the serving partition rules of tensor-parallel serving
(:data:`SERVING_RULES`, :func:`shard_serving_params`), which split
serving parameters into per-shard trees.

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
import re
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import transformer as tfm
from ..ops.lora import LoRAWeight
from ..ops.quant import QTensor
from .mesh import AXIS_DATA, AXIS_FSDP, AXIS_SEQ, Mesh


def leaves(tree) -> list:
    """The leaves of a nested dict whose nodes may also be tuples (the int8
    and LoRA wrappers), in JAX's tree order: dict keys sorted, tuple fields
    in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def _rebuild(tree, flat: list):
    """A tree of the same shape as ``tree`` (:func:`leaves`) over ``flat``."""
    it = iter(flat)

    def node(t):
        if isinstance(t, dict):
            return {k: node(t[k]) for k in sorted(t)}
        if isinstance(t, tuple):
            kids = [node(v) for v in t]
            return type(t)(*kids) if hasattr(t, "_fields") else tuple(kids)
        return next(it)

    return node(tree)


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors, fp32 (``optax.global_norm``)."""
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]
                       ).square().sum().sqrt()


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps=1e-8, weight_decay)``, optionally
    after ``optax.clip_by_global_norm``, updating in place. ``b1``/``b2``
    default to 0.9/0.95, the JAX package's ``make_optimizer``; its LoRA
    step uses optax's own defaults, 0.9/0.999.

    What optax does, matched here: the schedule is read at the step count
    BEFORE its increment (a warmup schedule's first update has lr 0 and
    only moves the moments); the bias corrections use the count after it;
    weight decay is added to the Adam direction for every leaf (no mask);
    clipping scales by ``max_norm / norm`` with no epsilon, and only when
    ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` would add
    1e-6 to the norm and always scale)."""

    eps = 1e-8

    def __init__(self, lr: float = 3e-4, weight_decay: float = 0.01,
                 warmup_steps: int = 0, total_steps: int = 0,
                 min_lr_ratio: float = 0.1, grad_clip: float = 0.0,
                 b1: float = 0.9, b2: float = 0.95):
        if total_steps and total_steps <= warmup_steps:
            raise ValueError(f"total_steps {total_steps} must exceed "
                             f"warmup_steps {warmup_steps}")
        self.b1, self.b2 = b1, b2
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


def _seq_size(mesh: Mesh) -> int:
    return mesh.shape.get(AXIS_SEQ, 1)


def _tokens_on(tokens, device) -> torch.Tensor:
    """A token batch (array-like or tensor) as int64 on ``device``."""
    if torch.is_tensor(tokens):
        return tokens.to(device).long()
    return torch.as_tensor(np.asarray(tokens), device=device).long()


def batch_spec(mesh: Mesh) -> tuple:
    """The token batch's partition spec (JAX ``batch_spec``): the batch over
    the data axes and, when the mesh has a ``seq`` axis, the sequence over
    it. Every shard of this package's mesh is on its one device, so the
    spec places nothing; it names the cut the ring and the step make."""
    return ((AXIS_DATA, AXIS_FSDP), AXIS_SEQ if _seq_size(mesh) > 1 else None)


def shard_batch(tokens, mesh: Mesh) -> torch.Tensor:
    """The batch placed for a step over ``mesh`` (JAX ``shard_batch``): on
    the mesh's device, as int64."""
    return _tokens_on(tokens, mesh.device)


def make_train_step(cfg: tfm.DecoderConfig, optimizer: Optional[AdamW] = None,
                    attn_fn: Optional[Callable] = None, remat: bool = False,
                    accum_steps: int = 1, aux_metrics: bool = False,
                    device=None, *, mesh: Optional[Mesh] = None):
    """Returns ``(init_state, step)`` for one device (CUDA unless
    ``device`` or ``mesh`` says otherwise; without CUDA and without either
    it raises). Parameters are fp32 (``init_params(..., dtype=float32)``,
    as ``init_sharded_params`` keeps them) and the forward computes in
    ``cfg.dtype``; ``attn_fn`` defaults to ``flash_attention`` — the
    kernels on the card, the plain version on the CPU.

    ``mesh`` (:mod:`.mesh`; JAX's second positional parameter, a keyword
    here so that the port's positional order stays) runs the step on the
    mesh's device. A ``seq`` axis above 1 defaults ``attn_fn`` to ring
    attention over it (:func:`.ring.make_ring_attention`: the K1 block
    kernels on the card), as JAX does; a ``data``, ``fsdp`` or ``model``
    axis above 1 raises ``NotImplementedError`` (ROADMAP item 12b).

    ``accum_steps > 1`` splits ``tokens [accum_steps·B, S]`` into equal
    microbatches, one live at a time, and applies the mean of their
    gradients (and losses) in one update. ``aux_metrics=True`` also
    returns ``{"grad_norm"}``, the global norm of the (unclipped) mean
    gradient. The loss and the norm stay device scalars: the step never
    syncs with the host."""
    optimizer = optimizer or make_optimizer()
    if mesh is not None:
        wide = {a: n for a, n in mesh.shape.items() if a != AXIS_SEQ and n > 1}
        if wide:
            raise NotImplementedError(
                f"training over mesh axes {wide} (data, FSDP or tensor "
                "parallelism) is not ported: ROADMAP item 12b")
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's device "
                             f"{mesh.device}")
        device = mesh.device
        if attn_fn is None and _seq_size(mesh) > 1:
            from .ring import make_ring_attention

            attn_fn = make_ring_attention(mesh, axis=AXIS_SEQ)
    device = resolve_device(device)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def init_state(seed: int = 0) -> dict:
        params = tfm.init_params(cfg, seed=seed, device=device,
                                 dtype=torch.float32)
        return {"params": params, "opt": optimizer.init(params), "step": 0}

    def step(state: dict, tokens):
        tokens = _tokens_on(tokens, device)
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


# ----- tensor-parallel serving ------------------------------------------------

# The JAX package's serving rules (``parallel/sharding.py`` SERVING_RULES):
# ``re.search`` over a leaf's dotted path, first match wins. Where JAX gives
# a PartitionSpec over the mesh's ``model`` axis, a rule here gives the axis
# of the stacked leaf that a shard splits, or None to replicate. Norms and
# embeddings replicate (a decode step reads one embedding row per token);
# attention and the MLP take the Megatron split: column-parallel q/k/v
# (fused wqkv and the Qwen2 biases along the same out axis) and gate/up,
# row-parallel wo and w_down, so each layer needs exactly one sum across
# shards after wo and one after w_down.
SERVING_RULES: tuple[tuple[str, Optional[int]], ...] = (
    (r"norm$", None),
    (r"^(embed|unembed)$", None),
    (r"layers\.(wq|wk|wv|wqkv)$", 2),
    (r"layers\.(bq|bk|bv|bqkv)$", 1),
    (r"layers\.wo$", 1),
    (r"layers\.(w_gate|w_up|w_gateup)$", 2),
    (r"layers\.w_down$", 1),
    (r"layers\.router$", None),
    (r"layers\.moe_w_(gate|in|out)$", 1),
)


def _layout_axis(axis: Optional[int], value: Any) -> Any:
    """A weight rule's axis expanded to its serving layout, as JAX's
    ``_layout_spec`` does: an int8 :class:`..ops.quant.QTensor`'s payload
    takes the rule's axis and its scale ``[..., 1, out]`` the same axis
    where that is the out axis (the reduced in axis stays whole); a
    :class:`..ops.lora.LoRAWeight`'s base follows its rule, ``a [..., in,
    r]`` takes the axis where it is the in axis, ``b [..., r, out]`` where
    it is the out axis, and ``scale`` stays whole, so a row-parallel sum
    carries ``x@a@b`` too."""
    if isinstance(value, LoRAWeight):
        last = value.a.ndim - 1
        return LoRAWeight(base=_layout_axis(axis, value.base),
                          a=axis if axis == last - 1 else None,
                          b=axis if axis == last else None, scale=None)
    if isinstance(value, QTensor):
        last = value.q.ndim - 1
        return QTensor(q=axis, scale=axis if axis == last else None)
    return axis


def _ref_tensor(value: Any) -> torch.Tensor:
    """The weight tensor of a leaf: itself, or a wrapper's payload."""
    while isinstance(value, tuple):
        value = value[0]
    return value


def match_partition_rules(rules, params: Any) -> Any:
    """The split axis of every leaf of ``params`` from ``(regex, axis)``
    rules, a tree of the same shape. Each leaf's dotted path
    (``layers.wqkv``) is matched with ``re.search`` in order, first match
    wins; a leaf of one element replicates; a path no rule covers raises
    (a silently replicated weight matrix would defeat the split)."""

    def axis_for(path: str, value: Any) -> Optional[int]:
        t = _ref_tensor(value)
        if t.numel() == 1:
            return None
        for pattern, axis in rules:
            if re.search(pattern, path):
                return axis
        raise ValueError(f"no serving partition rule matches param {path!r}")

    def node(value: Any, path: str) -> Any:
        if isinstance(value, dict):
            return {k: node(v, f"{path}.{k}" if path else k)
                    for k, v in value.items()}
        return _layout_axis(axis_for(path, value), value)

    return node(params, "")


def serving_param_specs(params: Any) -> Any:
    """:data:`SERVING_RULES` applied to ``params`` (any serving layout)."""
    return match_partition_rules(SERVING_RULES, params)


def decode_attn_specs(cfg, tp: int, quantized: bool, kv_layout: str = "heads"):
    """``(q_axis, kv_axis, out_axis)`` of the paged decode attention under
    tensor-parallel serving (JAX ``decode_attn_specs``), for q ``[B, S, H,
    D]``, a pool slice ``[1, NT, KV, D]`` and the output: the head axis (2)
    of all three when the KV heads divide ``tp``; under "blocks" the
    pool's token axis (1) with q and the output replicated (None); else
    everything replicated (the kv-replicated layout). An int8 pool's
    payload and scales share the axis."""
    from ..guest.tp_serving import KV_LAYOUT_BLOCKS, kv_heads_shardable

    if kv_layout == KV_LAYOUT_BLOCKS:
        head, kv = None, 1
    else:
        head = kv = 2 if kv_heads_shardable(cfg, tp) else None
    return head, QTensor(q=kv, scale=kv) if quantized else kv, head


# Fused inference weights: each concatenates parts along its out axis, and
# a shard keeps its own slice of every part.
_FUSED_PARTS = {
    "wqkv": lambda cfg: (cfg.q_dim, cfg.kv_dim, cfg.kv_dim),
    "bqkv": lambda cfg: (cfg.q_dim, cfg.kv_dim, cfg.kv_dim),
    "w_gateup": lambda cfg: (cfg.d_ff, cfg.d_ff),
}


def _split(t: torch.Tensor, axis: Optional[int], tp: int,
           parts: tuple = ()) -> list:
    """``tp`` contiguous per-shard copies of ``t`` cut along ``axis`` (the
    same tensor for every shard when ``axis`` is None); with ``parts`` each
    part along the axis is cut and shard ``s`` concatenates its pieces."""
    if axis is None:
        return [t] * tp
    if any(n % tp for n in parts or (t.shape[axis],)):
        raise ValueError(f"a split of {tuple(t.shape)} along axis {axis} "
                         f"(parts {parts}) does not divide tp={tp}")
    if not parts:
        return [c.contiguous() for c in t.chunk(tp, dim=axis)]
    pieces = [p.chunk(tp, dim=axis) for p in t.split(list(parts), dim=axis)]
    return [torch.cat([p[s] for p in pieces], dim=axis) for s in range(tp)]


def shard_serving_params(params: dict, cfg, tp: int) -> list:
    """``tp`` per-shard parameter trees by :data:`SERVING_RULES`: every
    layer leaf is cut along its rule's axis (an int8 QTensor's payload and
    scale alike, the scale whole where its axis is the reduced one; a LoRA
    adapter by :func:`_layout_axis`), a fused ``wqkv``/``bqkv``/
    ``w_gateup`` part by part, so that shard ``s``
    holds heads ``[s·H/tp, (s+1)·H/tp)`` of q and its slice of k, v and the
    MLP; replicated leaves are the same tensors in every tree. Raises when
    a split axis does not divide ``tp``."""
    specs = serving_param_specs(params)
    trees = [{k: v for k, v in params.items() if k != "layers"}
             for _ in range(tp)]
    for s in range(tp):
        trees[s]["layers"] = {}
    for name, leaf in params["layers"].items():
        axis = specs["layers"][name]
        parts = _FUSED_PARTS[name](cfg) if name in _FUSED_PARTS else ()
        cut = _cut(leaf, axis, tp, parts)
        for s in range(tp):
            trees[s]["layers"][name] = cut[s]
    return trees


def _cut(leaf: Any, axis: Any, tp: int, parts: tuple) -> list:
    """:func:`_split` of a leaf, a wrapper field by field (``axis`` the
    same wrapper of axes, :func:`_layout_axis`)."""
    if isinstance(leaf, tuple):
        fields = [_cut(t, a, tp, parts) for t, a in zip(leaf, axis)]
        return [type(leaf)(*f) for f in zip(*fields)]
    return _split(leaf, axis, tp, parts)
