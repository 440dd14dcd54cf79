"""LoRA: low-rank adapters for parameter-efficient fine-tuning
(counterpart of ``kata_xpu_device_plugin_tpu/ops/lora.py``).

A weight is wrapped in a :class:`LoRAWeight` and the one weight-apply hook
(:func:`.quant.weight_matmul`) dispatches on it, so the decoder layer,
generation, serving and tensor-parallel serving run adapted trees
unchanged:

    y = x @ base.detach() + ((x @ a) @ b) * (alpha / rank)

- ``base`` is frozen: it is detached in the matmul, so no gradient reaches
  it and the optimizer state covers the adapters alone.
- ``base`` may be an int8 :class:`.quant.QTensor` (QLoRA: frozen int8
  weights through the quantized matmul, adapters on top).
- ``b`` starts at zero, so a freshly adapted model is exactly the base.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence

import torch

from .quant import QTensor, dequantize, weight_matmul

# Layer-dict keys that take adapters by default: the attention projections
# of the training layout (fused layouts pass e.g. ("wqkv", "wo")).
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


class LoRAWeight(NamedTuple):
    """A frozen base weight and a trainable low-rank delta. Stacked over
    layers, every field carries the leading ``[L]`` axis, ``scale`` too."""

    base: Any  # [..., in, out] tensor or QTensor
    a: torch.Tensor  # [..., in, r]
    b: torch.Tensor  # [..., r, out]
    scale: torch.Tensor  # [...] fp32, alpha / rank


def lora_matmul(x: torch.Tensor, w: LoRAWeight) -> torch.Tensor:
    """``x @ w`` with the base detached and the low-rank path in the
    activation dtype."""
    base = w.base
    if isinstance(base, QTensor):
        base = QTensor(base.q.detach(), base.scale.detach())
    else:
        base = base.detach()
    y = weight_matmul(x, base)
    delta = (x @ w.a.to(x.dtype)) @ w.b.to(x.dtype)
    return y + delta * w.scale.to(x.dtype)


def _wrap(w: Any, generator: torch.Generator, rank: int,
          alpha: float) -> LoRAWeight:
    """A fresh adapter around ``w``: ``a`` normal / sqrt(in) from
    ``generator``, ``b`` zeros, ``scale`` alpha / rank over the leading
    axes, all fp32 on w's device."""
    ref = w.q if isinstance(w, QTensor) else w
    *lead, d_in, d_out = ref.shape
    a = torch.randn((*lead, d_in, rank), generator=generator,
                    device=ref.device, dtype=torch.float32) / math.sqrt(d_in)
    b = torch.zeros((*lead, rank, d_out), dtype=torch.float32, device=ref.device)
    scale = torch.full(tuple(lead), alpha / rank, dtype=torch.float32,
                       device=ref.device)
    return LoRAWeight(w, a, b, scale)


def apply_lora(params: dict, generator: torch.Generator, rank: int = 8,
               alpha: float = 16.0,
               targets: Sequence[str] = DEFAULT_TARGETS) -> dict:
    """Wrap each present target of ``params['layers']`` in a fresh adapter
    (``b = 0``: the adapted model equals the base), drawn from
    ``generator`` in the order of ``targets``. Works on the training
    layout, the fused layout (``targets=("wqkv", ...)``) and int8 bases
    (QLoRA).

    A tree held as a mesh's pieces (a ``fit`` state of
    ``make_train_step(mesh=)``) is gathered whole first: every shard lies
    on the mesh's one device, so the result is the plain tree that the
    one-device step takes (and that ``make_lora_train_step(mesh=)`` cuts
    again), where JAX keeps its arrays' shardings."""
    from ..parallel.sharding import whole_params

    params = whole_params(params)
    layers = params["layers"]
    present = [t for t in targets if t in layers]
    if not present:
        raise ValueError(
            f"no LoRA targets {tuple(targets)} in layers {sorted(layers)} — "
            "fused layouts need e.g. targets=('wqkv',)")
    out_layers = dict(layers)
    for t in present:
        out_layers[t] = _wrap(layers[t], generator, rank, alpha)
    out = dict(params)
    out["layers"] = out_layers
    return out


def merge_lora(params: dict) -> dict:
    """Fold the adapters into plain weights: ``base + (a @ b) * scale`` in
    fp32, back in the base's dtype; an int8 (QLoRA) base dequantizes and
    merges to fp32 (re-quantize the result to serve it int8)."""
    def fold(w):
        if not isinstance(w, LoRAWeight):
            return w
        base = dequantize(w.base) if isinstance(w.base, QTensor) else w.base
        delta = (w.a.float() @ w.b.float()) * w.scale.float()[..., None, None]
        return (base.float() + delta).to(base.dtype)

    out = dict(params)
    out["layers"] = {k: fold(v) for k, v in params["layers"].items()}
    return out


def lora_trainable_mask(params: Any) -> Any:
    """A tree like ``params`` of bools: True at the adapters' ``a`` and
    ``b``, False everywhere else (bases, scales, other leaves)."""
    from ..parallel.sharding import _rebuild, leaves

    def fill(node, value: bool):  # one entry a leaf (a Sharded one's pieces)
        return _rebuild(node, [value] * len(leaves(node)))

    def false(node):
        return fill(node, False)

    def mask_node(node):
        if isinstance(node, LoRAWeight):
            return LoRAWeight(false(node.base), fill(node.a, True),
                              fill(node.b, True), false(node.scale))
        return false(node)

    return {k: ({kk: mask_node(vv) for kk, vv in v.items()} if k == "layers"
                else false(v))
            for k, v in params.items()}


def split_trainable(params: Any):
    """``(trainable, rebuild)``: the adapters' ``a``/``b`` tensors in tree
    order, and ``rebuild(new)`` that reassembles the whole tree around
    ``new`` in their place, the frozen leaves as they are."""
    from ..parallel.sharding import _rebuild, leaves

    mask = leaves(lora_trainable_mask(params))
    flat = leaves(params)
    trainable = [x for x, m in zip(flat, mask) if m]
    frozen = [x for x, m in zip(flat, mask) if not m]

    def rebuild(new):
        it_t, it_f = iter(new), iter(frozen)
        return _rebuild(params, [next(it_t) if m else next(it_f) for m in mask])

    return trainable, rebuild


def make_lora_train_step(cfg, lr: float = 1e-4, attn_fn: Any = None,
                         mesh: Optional[Any] = None):
    """``(init_state, step)`` for fine-tuning an adapted tree: the step
    differentiates and updates only the adapters (:func:`split_trainable`),
    in place, with ``optax.adamw(lr)``'s numerics (b1 0.9, b2 0.999,
    eps 1e-8, weight decay 1e-4). ``init_state(params)`` gives
    ``{"params", "opt", "step"}``; ``step(state, tokens)`` gives ``(state,
    loss)`` on the params' device. ``attn_fn`` defaults to
    ``flash_attention`` (the kernels on the card).

    ``mesh`` (a :class:`..parallel.mesh.Mesh`): ``init_state`` cuts the
    adapted tree into its pieces by ``parallel.sharding.param_specs``
    (each base by its rule, a QLoRA base as a QTensor of pieces, ``a`` on
    its in axis and ``b`` on its out axis, ``scale`` whole), the AdamW
    moments mirror the adapter pieces, and the step runs the sharded
    program (``parallel.spmd``; ``attn_fn`` then defaults by mesh, the
    kernels per local block on the card)."""
    from ..models.transformer import next_token_loss
    from ..parallel.sharding import AdamW, _tokens_on

    optimizer = AdamW(lr, weight_decay=1e-4, b1=0.9, b2=0.999)
    if getattr(mesh, "procs", None) is not None:
        raise ValueError("LoRA training over a process mesh is not ported "
                         "yet; train over a one-process mesh")
    if mesh is not None:
        from ..parallel import spmd
        from ..parallel.sharding import mesh_attention

        if attn_fn is None:
            attn_fn = mesh_attention(cfg, mesh)

        def loss_fn(params, tokens):
            return spmd.next_token_loss(params, tokens, cfg, mesh,
                                        attn_fn=attn_fn)
    else:
        def loss_fn(params, tokens):
            return next_token_loss(params, tokens, cfg, attn_fn=attn_fn)

    def as_tree(ts: list) -> dict:
        return {f"{i:06d}": t for i, t in enumerate(ts)}

    def init_state(params: dict) -> dict:
        if mesh is not None:
            from ..parallel.sharding import shard_params

            params = shard_params(params, mesh)
        trainable, _ = split_trainable(params)
        if not trainable:
            raise ValueError("no LoRA adapters in params: apply_lora first")
        return {"params": params, "opt": optimizer.init(as_tree(trainable)),
                "step": 0}

    def step(state: dict, tokens):
        from ..parallel.sharding import leaves

        params = state["params"]
        tokens = _tokens_on(tokens, leaves(params["embed"])[0].device)
        trainable, rebuild = split_trainable(params)
        xs = [t.detach().requires_grad_() for t in trainable]
        with torch.enable_grad():
            loss = loss_fn(rebuild(xs), tokens)
            grads = list(torch.autograd.grad(loss, xs))
        optimizer.update(as_tree(trainable), grads, state["opt"])
        state["step"] += 1
        return state, loss.detach()

    return init_state, step
