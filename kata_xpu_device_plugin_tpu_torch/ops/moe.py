"""Mixture-of-experts FFN: top-k routing, capacity, sort-based dispatch
(counterpart of ``kata_xpu_device_plugin_tpu/ops/moe.py``, one device).

- Routing is top-k over an fp32 softmax: at k=1 the raw chosen probability
  is the gate (Switch), at k>1 the gates are renormalised over the chosen k
  (Mixtral). Ties go to the lower expert index, as ``jax.lax.top_k`` takes
  them (a stable descending sort; ``torch.topk`` promises no order).
- Dispatch is a stable sort of the token copies by expert id; a copy's
  slot in its expert's capacity buffer is its rank among that expert's
  copies (an exclusive cumsum of the per-expert counts). Copies past the
  capacity are dropped: parked at their expert's slot 0 with a zero
  contribution and a zero gate, so their token's residual carries them.
  Memory is O(T·K + E·C·d); no dense ``[T, E, C]`` dispatch tensor exists.
- Nothing syncs with the host: counts come from ``scatter_add_`` into a
  zeros tensor (``torch.bincount`` reads its size on the host), and the
  capacity depends only on the call's token count, so a CUDA graph can
  hold a whole MoE layer at a fixed batch shape.
- The combine sums each token's K weighted copies in ascending expert
  order, one add after another: deterministic for every K (an
  ``index_add_`` of K > 2 copies onto one row adds in whatever order the
  atomics land), so a replay is bit-equal to eager; at K <= 2 it equals
  JAX's scatter-add bit for bit.

The expert-parallel form (JAX ``moe_ffn_sharded``, ``expert_mesh``) needs
an expert mesh across devices and is not ported (ROADMAP item 12b).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from .quant import QTensor, bmm_f32

Params = dict


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    # Per-expert buffer = ceil(T*top_k/experts * factor); token copies routed
    # past it are dropped (their residual stream passes through unchanged).
    capacity_factor: float = 2.0
    top_k: int = 1

    def __post_init__(self):
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(
                f"top_k={self.top_k} must be in [1, num_experts={self.num_experts}]")


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert for a call over ``tokens`` tokens (JAX's formula,
    evaluated in the same float order)."""
    return max(1, math.ceil(tokens * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor))


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, *,
                    dtype=torch.float32) -> Params:
    """Router ``[d, E]`` and expert-major weights ``w_gate``/``w_in`` ``[E,
    d, f]`` and ``w_out`` ``[E, f, d]``, normal / sqrt(fan_in), drawn from
    ``generator`` on its device."""
    device = generator.device
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    return {"router": dense((d, e), d), "w_gate": dense((e, d, f), d),
            "w_in": dense((e, d, f), d), "w_out": dense((e, f, d), f)}


def _route(params: Params, tokens: torch.Tensor, cfg: MoEConfig):
    """``(gates [T, K] fp32, experts [T, K] int64, probs [T, E] fp32)``."""
    logits = tokens @ params["router"].to(tokens.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    if cfg.top_k == 1:
        gates = top_p  # Switch: the raw chosen probability
    else:
        gates = top_p / top_p.sum(dim=-1, keepdim=True)  # Mixtral
    return gates, top_e, probs


def _dispatch(tokens: torch.Tensor, top_e: torch.Tensor, gates: torch.Tensor,
              E: int, cap: int):
    """The sort-based dispatch: ``(expert_in [E, C, d], slot, weight,
    counts, order)`` where ``order`` sorts the flat copies (``t*K + j``) by
    expert, stably, and ``slot``/``weight`` are in that order."""
    T, K = gates.shape
    d = tokens.shape[-1]
    dev = tokens.device
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = order // K
    sorted_gate = gates.reshape(-1)[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - starts[sorted_e]
    kept = pos < cap
    slot = sorted_e * cap + torch.where(kept, pos, torch.zeros_like(pos))
    contrib = tokens[sorted_tok] * kept[:, None].to(tokens.dtype)
    # A kept copy owns its slot; a dropped one adds zeros at slot 0, so
    # every slot's sum is one value plus zeros, whatever the order.
    expert_in = torch.zeros((E * cap, d), dtype=tokens.dtype,
                            device=dev).index_add_(0, slot, contrib)
    weight = (sorted_gate * kept).to(tokens.dtype)
    return expert_in.reshape(E, cap, d), slot, weight, counts, order


def _expert_einsum(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Expert-major ``x [E, C, i] @ w [E, i, o]``. An int8 :class:`QTensor`
    expert stack is cast to the activation dtype for an fp32-accumulated
    product, and its per-expert scale ``[E, 1, o]`` multiplies the RESULT
    (weight-only int8; W8A8 does not apply to experts, as in JAX). The
    cast makes a whole activation-dtype copy of the stack each call."""
    if isinstance(w, QTensor):
        y = bmm_f32(x, w.q.to(x.dtype))
        return (y * w.scale.float()).to(x.dtype)
    return torch.bmm(x, w.to(x.dtype))


def _expert_mlp(params: Params, expert_in: torch.Tensor) -> torch.Tensor:
    """``[E, C, d] -> [E, C, d]``: the silu-gated MLP of every expert."""
    h = (F.silu(_expert_einsum(expert_in, params["w_gate"]))
         * _expert_einsum(expert_in, params["w_in"]))
    return _expert_einsum(h, params["w_out"])


def _combine(expert_out: torch.Tensor, slot: torch.Tensor, weight: torch.Tensor,
             order: torch.Tensor, top_e: torch.Tensor) -> torch.Tensor:
    """Each copy's expert output times its gate, summed per token in
    ascending expert order (the order a sequential scatter-add over the
    expert-sorted copies takes). Dropped copies weigh zero."""
    T, K = top_e.shape
    d = expert_out.shape[-1]
    gathered = expert_out.reshape(-1, d)[slot] * weight[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    per_copy = gathered[inv].reshape(T, K, d)  # copy t*K + j at [t, j]
    by_expert = torch.argsort(top_e, dim=-1)  # distinct experts: no ties
    per_copy = torch.gather(per_copy, 1, by_expert[:, :, None].expand(T, K, d))
    y = torch.zeros((T, d), dtype=expert_out.dtype, device=expert_out.device)
    for j in range(K):
        y = y + per_copy[:, j]
    return y


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig):
    """The MoE FFN over ``x [..., d]``: ``(y, aux_loss)``, ``aux_loss`` the
    load-balancing term ``E * sum_e(fraction routed_e * mean prob_e)``,
    the fractions counted BEFORE capacity drops (clamping them by what was
    kept would cap a collapsed router's penalty). The capacity comes from
    this call's own token count."""
    shape = x.shape
    tokens = x.reshape(-1, cfg.d_model)
    T, E, K = tokens.shape[0], cfg.num_experts, cfg.top_k
    gates, top_e, probs = _route(params, tokens, cfg)
    expert_in, slot, weight, counts, order = _dispatch(
        tokens, top_e, gates, E, capacity(cfg, T))
    expert_out = _expert_mlp(params, expert_in)
    y = _combine(expert_out, slot, weight, order, top_e)
    frac_routed = counts.float() / (T * K)
    aux = E * torch.sum(frac_routed * probs.mean(dim=0))
    return y.reshape(shape), aux


def reference_moe(params: Params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Token by token, no capacity and no dispatch: what :func:`moe_ffn`
    gives when nothing is dropped."""
    from .quant import dequantize

    def w(name, e):
        v = params[name]
        return (dequantize(QTensor(v.q[e], v.scale[e]), x.dtype)
                if isinstance(v, QTensor) else v[e].to(x.dtype))

    tokens = x.reshape(-1, cfg.d_model)
    gates, top_e, _ = _route(params, tokens, cfg)
    rows = []
    for t in range(tokens.shape[0]):
        tok = tokens[t]
        out = torch.zeros_like(tok)
        for j in range(cfg.top_k):
            e = int(top_e[t, j])
            h = F.silu(tok @ w("w_gate", e)) * (tok @ w("w_in", e))
            out = out + gates[t, j].to(tok.dtype) * (h @ w("w_out", e))
        rows.append(out)
    return torch.stack(rows).reshape(x.shape)
