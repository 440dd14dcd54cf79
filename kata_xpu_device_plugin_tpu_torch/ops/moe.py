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

The expert-parallel form (JAX ``moe_ffn_sharded``): tokens cut over every
axis of a mesh, experts over its expert axis (``expert``, or ``model`` on
a training mesh), the capacity buffers exchanged by
``collectives.all_to_all``. Every shard is on the mesh's one device and
runs in turn.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from . import collectives
from .quant import QTensor, bmm_f32

AXIS_EXPERT = "expert"  # parallel.mesh.AXIS_EXPERT (ops does not import parallel)

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
             order: torch.Tensor, top_e: torch.Tensor,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each copy's expert output times its gate, summed per token in
    ascending expert order (the order a sequential scatter-add over the
    expert-sorted copies takes). Dropped copies weigh zero, and so do the
    copies ``keep`` (in sorted order) leaves out."""
    T, K = top_e.shape
    d = expert_out.shape[-1]
    gathered = expert_out.reshape(-1, d)[slot] * weight[:, None]
    if keep is not None:
        gathered = torch.where(keep[:, None], gathered,
                               torch.zeros((), dtype=gathered.dtype,
                                           device=gathered.device))
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


def moe_ffn_tp(params: Params, x: torch.Tensor, cfg: MoEConfig):
    """:func:`moe_ffn` under tensor-parallel serving (JAX's ``moe_ffn``
    over the serving rules, which cut the expert stacks over the model
    axis and replicate the router; GSPMD partitions the one global
    dispatch): ``params["w_gate"/"w_in"/"w_out"]`` are lists of the
    shards' stacks, ``E/tp`` consecutive experts each. The tokens are
    routed and dispatched once, at :func:`moe_ffn`'s capacity over all of
    them (a per-shard capacity would drop other copies); shard ``s`` runs
    its experts' MLPs on their capacity slots and combines its own copies
    in the fixed expert order; the shards' outputs are summed
    (``all_reduce_sum``). At K <= 2 the result equals :func:`moe_ffn`'s bit
    for bit."""
    shape = x.shape
    tokens = x.reshape(-1, cfg.d_model)
    T, E, K = tokens.shape[0], cfg.num_experts, cfg.top_k
    tp = len(params["w_gate"])
    if E % tp:
        raise ValueError(f"{E} experts do not divide over {tp} shards")
    gates, top_e, probs = _route(params, tokens, cfg)
    cap = capacity(cfg, T)
    expert_in, slot, weight, counts, order = _dispatch(
        tokens, top_e, gates, E, cap)
    n = E // tp
    parts = []
    for s in range(tp):
        mlp = {k: params[k][s] for k in ("w_gate", "w_in", "w_out")}
        out = _expert_mlp(mlp, expert_in[s * n:(s + 1) * n])
        lo = s * n * cap
        mine = (slot >= lo) & (slot < lo + n * cap)
        parts.append(_combine(out, torch.where(mine, slot - lo,
                                               torch.zeros_like(slot)),
                              weight, order, top_e, keep=mine))
    y = collectives.all_reduce_sum(parts)
    frac_routed = counts.float() / (T * K)
    aux = E * torch.sum(frac_routed * probs.mean(dim=0))
    return y.reshape(shape), aux


def moe_param_specs() -> Params:
    """The specs of an expert tree (JAX ``moe_param_specs``): the router
    whole, the expert stacks cut on their expert dim over ``expert``."""
    return {"router": (), "w_gate": (AXIS_EXPERT,), "w_in": (AXIS_EXPERT,),
            "w_out": (AXIS_EXPERT,)}


def expert_axis_for(mesh) -> str:
    """The mesh axis experts split over: ``expert`` when the mesh has one,
    else ``model`` (a training mesh's tensor axis doubles as the expert
    axis, as in JAX)."""
    if mesh is None or AXIS_EXPERT in mesh.axis_names:
        return AXIS_EXPERT
    return "model"


def _assign_token_axes(lead, axes, mesh, expert_axis: str):
    """Each mesh axis (of size > 1) placed on the batch or the sequence dim
    of a ``[B, S, d]`` activation (JAX's rule): data-like axes prefer the
    batch, ``seq`` and the expert axis the sequence, either falling back to
    the other dim when its size does not divide. ``(b_axes, s_axes)``, or
    None when no placement covers every axis."""
    b_rem, s_rem = lead
    b_axes, s_axes = [], []
    for a in axes:
        n = mesh.shape[a]
        if n == 1:
            continue
        prefer_s = a == expert_axis or a == "seq"
        for dim in (("s", "b") if prefer_s else ("b", "s")):
            if dim == "b" and b_rem % n == 0:
                b_axes.append(a)
                b_rem //= n
                break
            if dim == "s" and s_rem % n == 0:
                s_axes.append(a)
                s_rem //= n
                break
        else:
            return None
    return tuple(b_axes), tuple(s_axes)


def dispatch_shardable(tokens_shape, num_experts: int, mesh,
                       expert_axis: Optional[str] = None) -> bool:
    """Whether :func:`moe_ffn_sharded` takes this token shape (``(B, S)``,
    the layout-aligned check, or a flat count) on ``mesh``."""
    expert_axis = expert_axis or expert_axis_for(mesh)
    if num_experts % mesh.shape[expert_axis]:
        return False
    all_axes = tuple(a for a in mesh.axis_names if a != expert_axis) + (
        expert_axis,)
    if isinstance(tokens_shape, (tuple, list, torch.Size)):
        return _assign_token_axes(tuple(tokens_shape), all_axes, mesh,
                                  expert_axis) is not None
    return tokens_shape % math.prod(mesh.shape.values()) == 0


def _radix(coords: dict, axes, mesh) -> tuple[int, int]:
    """``(index, count)`` of a device along a dim cut over ``axes`` (the
    first axis major, as a spec's axis tuple orders them)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def _expert_shards(w: Any, ep: int) -> list:
    """An expert stack as its ``ep`` shards: a list already cut (a training
    mesh's model shards) as it is, a whole stack (or QTensor) chunked on
    its expert dim."""
    if isinstance(w, list):
        if len(w) != ep:
            raise ValueError(f"{len(w)} expert shards for an axis of {ep}")
        return w
    if isinstance(w, QTensor):
        return [QTensor(q, sc) for q, sc in zip(w.q.chunk(ep), w.scale.chunk(ep))]
    return list(w.chunk(ep))


def moe_ffn_sharded(params: Params, x: torch.Tensor, cfg: MoEConfig, mesh,
                    expert_axis: Optional[str] = None):
    """The data-sharded MoE FFN (JAX ``moe_ffn_sharded``, the GShard
    layout): ``(y, aux)``. Tokens are cut over every mesh axis (a ``[B,
    S, d]`` activation by :func:`_assign_token_axes`, else the flat tokens
    over all axes in mesh order), so each shard routes and dispatches its
    own ``T_loc = T / n`` tokens at the capacity ``ceil(T_loc·K/E·factor)``
    (where tokens drop this differs from :func:`moe_ffn`, as JAX's does);
    experts are cut over ``expert_axis`` (``params`` may hold each expert
    stack as the list of its shards). Within each group of shards that
    differ only along the expert axis, two ``collectives.all_to_all``
    exchanges move the ``[E, C, d]`` buffers to the experts' owners and
    back. ``aux`` comes from the GLOBAL routing fractions: counts and
    probability sums added over every shard in order. The combine is
    :func:`_combine`'s, order-free."""
    expert_axis = expert_axis or expert_axis_for(mesh)
    names = tuple(mesh.axis_names)
    all_axes = tuple(a for a in names if a != expert_axis) + (expert_axis,)
    n_total = math.prod(mesh.shape[a] for a in all_axes)
    ep = mesh.shape[expert_axis]
    shape = x.shape
    d = cfg.d_model
    T = math.prod(shape[:-1])
    E, K = cfg.num_experts, cfg.top_k
    if E % ep:
        raise ValueError(f"{E} experts not divisible by {expert_axis}={ep}")
    placement = (_assign_token_axes(tuple(shape[:2]), all_axes, mesh,
                                    expert_axis) if x.ndim == 3 else None)
    if x.ndim == 3 and placement is None and T % n_total:
        raise ValueError(f"tokens {tuple(shape[:-1])} not divisible by mesh "
                         f"size {n_total}")
    if placement is None and T % n_total:
        raise ValueError(f"token count {T} not divisible by mesh size {n_total}")
    t_loc = T // n_total
    cap = capacity(cfg, t_loc)
    experts = {n: _expert_shards(params[n], ep)
               for n in ("w_gate", "w_in", "w_out")}

    # Every shard's coordinates, in mesh order, and its token block.
    grid = [dict(zip(names, c)) for c in _product([mesh.shape[a] for a in names])]
    flat = x.reshape(-1, d)

    def block(c):
        if placement is None:
            i, _ = _radix(c, all_axes, mesh)
            return flat[i * t_loc:(i + 1) * t_loc]
        (bi, nb), (si, ns) = (_radix(c, placement[0], mesh),
                              _radix(c, placement[1], mesh))
        B, S = shape[0] // nb, shape[1] // ns
        return x[bi * B:(bi + 1) * B, si * S:(si + 1) * S].reshape(-1, d)

    routed = {}
    for i, c in enumerate(grid):
        tok = block(c)
        gates, top_e, probs = _route(params, tok, cfg)
        expert_in, slot, weight, counts, order = _dispatch(tok, top_e, gates,
                                                           E, cap)
        routed[i] = (expert_in, slot, weight, counts, order, top_e, probs)
    # The exchange, group by group: shard j of a group receives its experts'
    # buffers from every shard of the group, [E/ep, ep·C, d].
    groups = {}
    for i, c in enumerate(grid):
        key = tuple(c[a] for a in names if a != expert_axis)
        groups.setdefault(key, []).append((c[expert_axis], i))
    expert_out = {}
    for members in groups.values():
        members.sort()
        ids = [i for _, i in members]
        recv = collectives.all_to_all([routed[i][0] for i in ids],
                                      split_dim=0, concat_dim=1)
        outs = [_expert_mlp({n: experts[n][j] for n in experts}, buf)
                for j, buf in enumerate(recv)]
        back = collectives.all_to_all(outs, split_dim=1, concat_dim=0)
        expert_out.update(zip(ids, back))
    ys = {}
    for i in range(len(grid)):
        _, slot, weight, _, order, top_e, _ = routed[i]
        ys[i] = _combine(expert_out[i], slot, weight, order, top_e)
    counts_g = collectives.all_reduce_sum([routed[i][3] for i in range(len(grid))])
    probs_g = collectives.all_reduce_sum(
        [routed[i][6].sum(dim=0) for i in range(len(grid))])
    aux = E * torch.sum((counts_g.float() / (T * K)) * (probs_g / T))
    if placement is None:
        order_ = sorted(range(len(grid)),
                        key=lambda i: _radix(grid[i], all_axes, mesh)[0])
        y = torch.cat([ys[i] for i in order_], dim=0)
        return y.reshape(shape), aux
    b_axes, s_axes = placement
    nb = _radix(grid[0], b_axes, mesh)[1]
    ns = _radix(grid[0], s_axes, mesh)[1]
    tiles = {}
    for i, c in enumerate(grid):
        tiles[(_radix(c, b_axes, mesh)[0], _radix(c, s_axes, mesh)[0])] = ys[i]
    B, S = shape[0] // nb, shape[1] // ns
    rows = [torch.cat([tiles[(bi, si)].reshape(B, S, d) for si in range(ns)],
                      dim=1) for bi in range(nb)]
    return torch.cat(rows, dim=0), aux


def _product(sizes: list) -> list:
    """Every coordinate tuple over ``sizes``, the last axis fastest."""
    out = [()]
    for n in sizes:
        out = [c + (i,) for c in out for i in range(n)]
    return out


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
