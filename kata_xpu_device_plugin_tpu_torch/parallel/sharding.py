"""The train step: AdamW as optax applies it, the training layout and
``make_train_step`` (counterpart of ``kata_xpu_device_plugin_tpu/parallel/
sharding.py``: ``PARAM_RULES``, ``param_specs``, ``shard_params``,
``init_sharded_params``, ``make_optimizer``, ``make_train_step``,
``batch_spec``, ``shard_batch``) on one device or over a mesh of data,
fsdp, model and seq axes, every shard on the mesh's device (:mod:`.mesh`).
And the serving partition rules of tensor-parallel serving
(:data:`SERVING_RULES`, :func:`shard_serving_params`), which split
serving parameters into per-shard trees.

The training layout. JAX gives each parameter a ``NamedSharding`` from
:data:`PARAM_RULES` and lets GSPMD insert the collectives. Here a
parameter cut by its rule is a :class:`Sharded` leaf: its pieces, one
contiguous tensor per mesh coordinate of the axes its spec names, so the
model is held once (an axis the spec does not name, ``data`` for every
parameter, adds no copy: on one device the copies a replica would hold
are the same tensor). The step runs the program GSPMD would produce,
shard by shard (:mod:`.spmd`): a layer's weights are gathered over fsdp
when it runs, products are column- or row-parallel over model, and
autograd through the gathers hands each piece the sum of its shards'
gradients (the reduce-scatter). AdamW updates the pieces, so its moments
mirror them, and the clip's global norm counts every element once.

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
from .mesh import AXIS_DATA, AXIS_FSDP, AXIS_MODEL, AXIS_SEQ, Mesh


class Sharded:
    """A tensor of ``shape`` held as its pieces: ``spec`` names, per dim,
    the mesh axis that cuts it (None: whole), ``cuts`` the number of
    pieces along each dim (the axis's size on the mesh), and ``pieces``
    lists them row-major over ``cuts``, each the ``torch.tensor_split``
    piece of its coordinates, contiguous and held once."""

    __slots__ = ("spec", "cuts", "pieces", "shape")

    def __init__(self, spec: tuple, cuts: tuple, pieces: list, shape):
        self.spec, self.cuts = tuple(spec), tuple(cuts)
        self.pieces, self.shape = list(pieces), torch.Size(shape)
        if len(self.pieces) != math.prod(self.cuts):
            raise ValueError(f"{len(self.pieces)} pieces for cuts {self.cuts}")

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, spec={self.spec}, "
                f"cuts={self.cuts})")

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def with_pieces(self, pieces: list) -> "Sharded":
        return Sharded(self.spec, self.cuts, pieces, self.shape)

    def select(self, **coords: int) -> torch.Tensor:
        """The tensor one shard sees: the pieces at ``coords`` (axis name
        to index) along the axes named there, gathered over every other
        cut (``collectives.all_gather``). No coordinates: the whole
        tensor."""
        from ..ops.collectives import all_gather

        def rec(d: int, flat: int) -> torch.Tensor:
            if d == len(self.cuts):
                return self.pieces[flat]
            n, axis = self.cuts[d], self.spec[d]
            if n == 1:
                return rec(d + 1, flat)
            if axis in coords:
                return rec(d + 1, flat * n + coords[axis])
            return all_gather([rec(d + 1, flat * n + i) for i in range(n)],
                              dim=d)

        return rec(0, 0)

    def stage(self, s: int) -> "Sharded":
        """Entry ``s`` of the first dim when that dim is cut into pieces of
        one (a stage-major leaf cut over ``pipe``): that piece row's
        pieces, views without the dim, still cut over the other axes."""
        n = self.cuts[0]
        if n != self.shape[0]:
            raise ValueError(f"the first dim of {self!r} is not cut into ones")
        per = len(self.pieces) // n
        return Sharded(self.spec[1:], self.cuts[1:],
                       [p[0] for p in self.pieces[s * per:(s + 1) * per]],
                       self.shape[1:])

    def layers(self) -> list:
        """Per-layer leaves of a layer-stacked leaf (its first dim uncut):
        one ``unbind`` per piece, as ``models.transformer._unbind`` does."""
        if self.cuts[0] != 1:
            raise ValueError(f"the layer axis of {self!r} is cut")
        per = [p.unbind(0) for p in self.pieces]
        return [Sharded(self.spec[1:], self.cuts[1:], [u[i] for u in per],
                        self.shape[1:]) for i in range(self.shape[0])]


def local(leaf: Any, **coords: int) -> Any:
    """:meth:`Sharded.select` of a leaf (no coordinates: its whole
    tensor): a tensor as it is, a wrapper (QTensor, LoRAWeight) field by
    field."""
    if isinstance(leaf, Sharded):
        return leaf.select(**coords)
    if isinstance(leaf, tuple):
        return type(leaf)(*(local(t, **coords) for t in leaf))
    return leaf


def layer_leaves(leaf: Any) -> list:
    """Per-layer views of a stacked leaf, Sharded or not (wrappers field by
    field)."""
    if isinstance(leaf, Sharded):
        return leaf.layers()
    if isinstance(leaf, tuple):
        parts = [layer_leaves(t) for t in leaf]
        return [type(leaf)(*p) for p in zip(*parts)]
    return list(leaf.unbind(0))


def leaves(tree) -> list:
    """The leaves of a nested dict whose nodes may also be tuples (the int8
    and LoRA wrappers), in JAX's tree order: dict keys sorted, tuple fields
    in order; a :class:`Sharded` leaf gives its pieces in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in leaves(v)]
    if isinstance(tree, Sharded):
        return list(tree.pieces)
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
        if isinstance(t, Sharded):
            return t.with_pieces([next(it) for _ in t.pieces])
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


# ----- the training layout ------------------------------------------------

# JAX's PARAM_RULES as data: a leaf's dotted path to its spec, one entry a
# dim, the mesh axis that cuts the dim or None. Layer-stacked leaves lead
# with the uncut layer axis. The wide matrices cut their wide dim over
# model and their d_model dim over fsdp; embed cuts vocab over model and
# d_model over fsdp; the MoE experts cut over model (the expert axis of the
# training mesh, ops.moe.expert_axis_for); norms are whole.
PARAM_RULES: dict[str, tuple] = {
    "embed": (AXIS_MODEL, AXIS_FSDP),
    "unembed": (AXIS_FSDP, AXIS_MODEL),
    "layers.attn_norm": (None, None),
    "layers.mlp_norm": (None, None),
    "layers.post_attn_norm": (None, None),
    "layers.post_mlp_norm": (None, None),
    "layers.q_norm": (None, None),
    "layers.k_norm": (None, None),
    "layers.wq": (None, AXIS_FSDP, AXIS_MODEL),
    "layers.wk": (None, AXIS_FSDP, AXIS_MODEL),
    "layers.wv": (None, AXIS_FSDP, AXIS_MODEL),
    "layers.bq": (None, AXIS_MODEL),
    "layers.bk": (None, AXIS_MODEL),
    "layers.bv": (None, AXIS_MODEL),
    "layers.bqkv": (None, AXIS_MODEL),
    "layers.wo": (None, AXIS_MODEL, AXIS_FSDP),
    "layers.w_gate": (None, AXIS_FSDP, AXIS_MODEL),
    "layers.w_up": (None, AXIS_FSDP, AXIS_MODEL),
    "layers.w_down": (None, AXIS_MODEL, AXIS_FSDP),
    "layers.wqkv": (None, AXIS_FSDP, AXIS_MODEL),
    "layers.w_gateup": (None, AXIS_FSDP, AXIS_MODEL),
    "layers.router": (None, AXIS_FSDP, None),
    "layers.moe_w_gate": (None, AXIS_MODEL, AXIS_FSDP, None),
    "layers.moe_w_in": (None, AXIS_MODEL, AXIS_FSDP, None),
    "layers.moe_w_out": (None, AXIS_MODEL, None, AXIS_FSDP),
    "final_norm": (None,),
}

BATCH_SPEC = ((AXIS_DATA, AXIS_FSDP), None)  # tokens [batch, seq]


def param_spec(path: str) -> tuple:
    if path in PARAM_RULES:
        return PARAM_RULES[path]
    raise KeyError(f"no sharding rule for param {path!r}")


def _tree_paths(params: Any, prefix: str = "") -> Any:
    if isinstance(params, dict):
        return {k: _tree_paths(v, f"{prefix}.{k}" if prefix else k)
                for k, v in params.items()}
    return prefix


def _layout_spec(rule: tuple, value: Any) -> Any:
    """A weight rule ``[..., in, out]`` expanded to the leaf's layout, as in
    JAX: a :class:`QTensor`'s ``q`` keeps the rule and its scale ``[..., 1,
    out]`` cuts the out axis alike; a :class:`LoRAWeight`'s base recurses,
    ``a [..., in, r]`` keeps the in axis's cut, ``b [..., r, out]`` the out
    axis's, and ``scale [...]`` the leading axes'."""
    rule = tuple(rule)
    if isinstance(value, LoRAWeight):
        lead = rule[:-2]
        return LoRAWeight(base=_layout_spec(rule, value.base),
                          a=(*lead, rule[-2], None), b=(*lead, None, rule[-1]),
                          scale=lead)
    if isinstance(value, QTensor):
        return QTensor(q=rule, scale=(*rule[:-2], None, rule[-1]))
    return rule


def param_specs(params: Any) -> Any:
    """The spec of every leaf of ``params``: the training layout and the
    inference layouts (fused wqkv/w_gateup, int8 QTensor, LoRA)."""

    def node(value: Any, path: str) -> Any:
        if isinstance(value, dict):
            return {k: node(v, f"{path}.{k}" if path else k)
                    for k, v in value.items()}
        return _layout_spec(param_spec(path), value)

    return node(params, "")


def _axis_size(mesh: Mesh, entry) -> int:
    """The pieces a spec entry cuts a dim into: the product of its axes'
    sizes on the mesh (an axis the mesh lacks counts 1)."""
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape.get(a, 1) for a in names if a is not None)


class Layout:
    """Where a leaf's pieces lie (JAX's ``NamedSharding``): its spec and
    the cuts the mesh gives it."""

    __slots__ = ("spec", "cuts")

    def __init__(self, spec: tuple, mesh: Mesh):
        self.spec = tuple(spec)
        if any(isinstance(e, tuple) for e in self.spec):
            raise ValueError(f"a parameter dim is cut by one axis: {spec}")
        self.cuts = tuple(_axis_size(mesh, e) for e in self.spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Layout) and self.spec == other.spec
                and self.cuts == other.cuts)

    def __repr__(self) -> str:
        return f"Layout(spec={self.spec}, cuts={self.cuts})"

    def _full(self, ndim: int) -> tuple:
        return (self.spec + (None,) * (ndim - len(self.spec)),
                self.cuts + (1,) * (ndim - len(self.cuts)))

    def holds(self, leaf: Any, device: torch.device) -> bool:
        """Is ``leaf`` already this layout's pieces on ``device``?"""
        if not isinstance(leaf, Sharded):
            return False
        spec, cuts = self._full(len(leaf.shape))
        return (leaf.spec == spec and leaf.cuts == cuts
                and all(p.device == device for p in leaf.pieces))

    def cut(self, t: torch.Tensor, copy: bool = False) -> Any:
        """``t`` as its pieces, each a contiguous copy; when nothing is cut,
        ``t`` itself (a copy with ``copy``)."""
        spec, cuts = self._full(t.ndim)
        if math.prod(cuts) == 1:
            return t.detach().clone() if copy else t
        return Sharded(spec, cuts, cut_pieces(t, cuts), t.shape)


def cut_pieces(t: torch.Tensor, cuts: tuple) -> list:
    """``t``'s pieces row-major over ``cuts`` (``torch.tensor_split`` per
    dim), each a contiguous copy of its own, so no piece keeps ``t``
    alive."""

    def rec(x: torch.Tensor, d: int) -> list:
        if d == t.ndim:
            return [x.clone(memory_format=torch.contiguous_format)]
        return [p for part in x.tensor_split(cuts[d], dim=d)
                for p in rec(part, d + 1)]

    with torch.no_grad():
        return rec(t, 0)


def _wrap_map(fn, layout: Any, leaf: Any) -> Any:
    """``fn(layout, tensor)`` over a leaf and its layout, wrappers field by
    field."""
    if isinstance(leaf, tuple):
        return type(leaf)(*(_wrap_map(fn, lo, t) for lo, t in zip(layout, leaf)))
    return fn(layout, leaf)


def _tree_map2(fn, layouts: Any, params: Any) -> Any:
    if isinstance(params, dict):
        return {k: _tree_map2(fn, layouts[k], v) for k, v in params.items()}
    return _wrap_map(fn, layouts, params)


def param_shardings(params: Any, mesh: Mesh) -> Any:
    """The :class:`Layout` of every leaf of ``params`` on ``mesh``."""

    def to_layout(spec):
        if hasattr(spec, "_fields"):  # a QTensor or LoRAWeight of specs
            return type(spec)(*(to_layout(s) for s in spec))
        return Layout(spec, mesh)

    def node(specs):
        if isinstance(specs, dict):
            return {k: node(v) for k, v in specs.items()}
        return to_layout(specs)

    return node(param_specs(params))


def shard_params(params: Any, mesh: Mesh, copy: bool = True) -> Any:
    """``params`` (whole tensors, or already sharded on another mesh) cut
    into pieces on ``mesh``'s device by :data:`PARAM_RULES`: a tree of its
    own, so a step that updates it in place leaves ``params`` as they
    were. ``copy=False`` (JAX's ``device_put`` of an array already so
    placed) passes through every leaf that already has its layout on the
    mesh's device, a :class:`Sharded` leaf of the same cuts or a whole
    tensor no axis cuts, so a tree born sharded
    (:func:`init_sharded_params`, a sharded checkpoint's restore) is taken
    as it is, never gathered whole."""

    def place(layout, t):
        if not copy and layout.holds(t, mesh.device):
            return t
        t = local(t)  # a leaf sharded otherwise: its whole tensor
        return layout.cut(t.to(mesh.device), copy=copy)

    return _tree_map2(place, param_shardings(params, mesh), params)


def init_sharded_params(cfg: tfm.DecoderConfig, mesh: Mesh, seed: int = 0,
                        dtype=torch.float32) -> Any:
    """``init_params(cfg, seed=seed)``'s values, born in the sharded layout
    on the mesh's device: each leaf is cut as soon as it is drawn, so at
    most one whole leaf exists at a time, never the whole model (JAX's
    ``jit(..., out_shardings=...)``)."""

    def place(path: str, t: torch.Tensor):
        return Layout(param_spec(path), mesh).cut(t)

    return tfm.init_params(cfg, seed=seed, device=mesh.device, dtype=dtype,
                           place=place)


def whole_params(params: Any) -> Any:
    """A (possibly sharded) param tree with every leaf gathered whole on its
    device, wrappers field by field; a whole leaf is taken as it is."""

    def node(v):
        if isinstance(v, dict):
            return {k: node(x) for k, x in v.items()}
        return _wrap_map(lambda _l, t: local(t), v, v)

    return node(params)


def host_param_copy(params: Any) -> Any:
    """A whole host copy of a (possibly sharded) param tree: every leaf
    gathered and moved to the CPU, wrappers field by field."""

    def node(v):
        if isinstance(v, dict):
            return {k: node(x) for k, x in v.items()}
        return _wrap_map(lambda _l, t: local(t).detach().cpu(), v, v)

    return node(params)


def _opt_shardings(optimizer: "AdamW", params: Any, mesh: Mesh) -> dict:
    """The optimizer state's layouts: the moments mirror the parameters'
    pieces, the step count is a host integer."""
    del optimizer
    layouts = param_shardings(params, mesh)
    return {"count": None, "mu": layouts, "nu": layouts}


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


def heads_divide(cfg: tfm.DecoderConfig, mesh: Mesh) -> bool:
    """Whether attention cuts its heads over the model axis: only when
    both the query and the KV heads divide it (JAX's rule), or a shard's
    query heads would lose their KV group."""
    tp = mesh.shape.get(AXIS_MODEL, 1)
    return tp > 1 and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0


def mesh_attention(cfg: tfm.DecoderConfig, mesh: Mesh) -> Optional[Callable]:
    """The attention a step over ``mesh`` takes by default (JAX
    ``make_train_step``): a ``seq`` axis above 1, ring attention with the
    batch over data x fsdp and the heads over model when they divide; any
    other mesh on CUDA, :func:`.flash_spmd.make_sharded_attention` over the
    same axes (the kernels per local block); on the CPU None, the plain
    path."""
    heads = AXIS_MODEL if heads_divide(cfg, mesh) else None
    if _seq_size(mesh) > 1:
        from .ring import make_ring_attention

        return make_ring_attention(mesh, axis=AXIS_SEQ,
                                   batch_axes=(AXIS_DATA, AXIS_FSDP),
                                   head_axis=heads, kv_head_axis=heads)
    if mesh.device.type == "cuda":
        from .flash_spmd import make_sharded_attention

        return make_sharded_attention(mesh, batch_axes=(AXIS_DATA, AXIS_FSDP),
                                      head_axis=heads, kv_head_axis=heads)
    return None


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
    mesh's device, over every mesh JAX takes: the parameters and the AdamW
    moments are the pieces of :data:`PARAM_RULES` on the mesh
    (``init_state`` draws ``init_params(cfg, seed)``'s values straight into
    them, :func:`init_sharded_params`; a leaf no axis cuts stays one
    tensor) and the step runs the sharded program (:mod:`.spmd`); MoE
    layers dispatch over the mesh (``moe_ffn_sharded``, experts over
    model). ``attn_fn`` then defaults by mesh (:func:`mesh_attention`):
    ring attention over a ``seq`` axis above 1 (the K1 block kernels on the
    card), the kernels per local block on other CUDA meshes, the plain
    path on the CPU.

    ``accum_steps > 1`` splits ``tokens [accum_steps·B, S]`` into equal
    microbatches, one live at a time, and applies the mean of their
    gradients (and losses) in one update. ``aux_metrics=True`` also
    returns ``{"grad_norm"}``, the global norm of the (unclipped) mean
    gradient. The loss and the norm stay device scalars: the step never
    syncs with the host."""
    from . import spmd

    optimizer = optimizer or make_optimizer()
    if mesh is not None:
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's device "
                             f"{mesh.device}")
        device = mesh.device
        if attn_fn is None:
            attn_fn = mesh_attention(cfg, mesh)
    device = resolve_device(device)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    moe_mesh = mesh if cfg.moe else None

    def init_state(seed: int = 0) -> dict:
        if mesh is not None:
            params = init_sharded_params(cfg, mesh, seed=seed)
        else:
            params = tfm.init_params(cfg, seed=seed, device=device,
                                     dtype=torch.float32)
        return {"params": params, "opt": optimizer.init(params), "step": 0}

    def loss_fn(params, mb):
        if mesh is not None:
            return spmd.next_token_loss(params, mb, cfg, mesh, attn_fn=attn_fn,
                                        remat=remat, moe_mesh=moe_mesh)
        return tfm.next_token_loss(params, mb, cfg, attn_fn=attn_fn,
                                   remat=remat)

    def step(state: dict, tokens):
        tokens = _tokens_on(tokens, device)
        if tokens.shape[0] % accum_steps:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"accum_steps={accum_steps}")
        params = state["params"]
        # Gradients are taken against detached aliases of the parameters
        # (their pieces, when sharded), so the state's tensors never
        # require grad and update in place.
        xs = [p.detach().requires_grad_() for p in leaves(params)]
        view = _rebuild(params, xs)
        grads, loss = None, None
        with torch.enable_grad():
            for mb in tokens.chunk(accum_steps):
                lm = loss_fn(view, mb)
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
    where that is the out axis or a leading one (an expert stack's ``E``);
    the reduced in axis stays whole; a
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
        return QTensor(q=axis, scale=None if axis == last - 1 else axis)
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
