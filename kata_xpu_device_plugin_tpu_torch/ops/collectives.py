"""Collectives over the shards of a mesh (counterpart of
``kata_xpu_device_plugin_tpu/ops/collectives.py`` and of the collectives
GSPMD and ``shard_map`` insert there: the model-axis sums of
tensor-parallel serving, the ``seq`` axis's neighbour hop, gather and
all-to-all).

Two forms of each collective:

- the list form, for a mesh whose shards all sit on one device
  (:class:`..guest.tp_serving.ServingMesh`, a one-process
  :class:`..parallel.mesh.Mesh`): a plain function over the list of
  per-shard tensors, indexed by shard. A reduction's result is one tensor
  that every shard reads: on one device the copies a multi-device
  collective would leave on each shard are the same tensor;
- the group form (``group_*``), for a process mesh
  (:func:`..parallel.mesh.process_mesh`), one shard a process: it takes
  the rank's own tensor and an :class:`AxisGroup`, one line of a mesh
  axis over a ``torch.distributed`` group, and is a real collective over
  it. NCCL takes the card's tensors; gloo takes host tensors, so over
  gloo a card's tensor goes through pinned host memory, explicitly, and
  :class:`HostStaging` counts the bytes. No backend failure is caught.

Sums add the shards in ascending order in both forms: the group form
gathers every rank's tensor and adds shard 0 first, so every rank gets the
same bits and a process mesh reproduces the list form's arithmetic. JAX's
overlapped form of the sum (a reduce-scatter then an all-gather, the
``KATA_TPU_TP_OVERLAP`` decomposition) is :func:`group_overlapped_sum`,
numerically the fused sum. On one device it hides no communication, so
the list form has none.

The differentiable forms the sharded train step runs on
(:func:`gather_pieces`, :func:`sum_shards`, :func:`enter_shards`,
:func:`exchange`) pair each group collective with its adjoint.
"""
from __future__ import annotations

from typing import Optional

import torch


def all_reduce_sum(parts: list) -> torch.Tensor:
    """``sum_s parts[s]``, shard 0 first (the fused psum)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def all_reduce_max(parts: list) -> torch.Tensor:
    """The elementwise max over shards (the pmax)."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out


def reduce_scatter(parts: list, dim: int = 0) -> list:
    """``lax.psum_scatter(tiled=True)``: shard j receives piece j (of n
    along ``dim``) of the sum over shards, added in ascending shard order
    as :func:`all_reduce_sum` adds."""
    pieces = [p.chunk(len(parts), dim=dim) for p in parts]
    return [all_reduce_sum([pc[j] for pc in pieces]) for j in range(len(parts))]


def ppermute(parts: list) -> list:
    """The ring's neighbour hop (``lax.ppermute`` with the permutation
    ``j -> j + 1 mod n``): shard j receives shard j - 1's tensor. On one
    device a rotation of the list; nothing is copied."""
    return parts[-1:] + parts[:-1]


def ring_all_reduce(parts: list) -> list:
    """The sum over shards by n - 1 neighbour hops (JAX
    ``ring_all_reduce``): every shard adds each block as it passes, so each
    ends holding the total, summed in its own ring order."""
    acc, blk = list(parts), list(parts)
    for _ in range(len(parts) - 1):
        blk = ppermute(blk)
        acc = [a + b for a, b in zip(acc, blk)]
    return acc


def all_gather(parts: list, dim: int = 0) -> torch.Tensor:
    """The shards concatenated along ``dim`` (``all_gather(tiled=True)``)."""
    return torch.cat(parts, dim=dim)


def all_to_all(parts: list, split_dim: int, concat_dim: int) -> list:
    """``lax.all_to_all(tiled=True)``: shard i's tensor is cut into n
    pieces along ``split_dim``; shard j receives piece j of every shard,
    concatenated in shard order along ``concat_dim``."""
    pieces = [p.chunk(len(parts), dim=split_dim) for p in parts]
    return [torch.cat([pc[j] for pc in pieces], dim=concat_dim)
            for j in range(len(parts))]


# ----- the group form ---------------------------------------------------------


class HostStaging:
    """The bytes the group collectives of one process mesh copied between
    a card and pinned host memory (to the host and back, each counted)."""

    __slots__ = ("bytes",)

    def __init__(self):
        self.bytes = 0


class AxisGroup:
    """One line of a process mesh's axis (or the whole mesh): the global
    ranks on it in line order, this rank's ``index`` among them, and the
    ``torch.distributed`` group over them. ``stage`` (gloo with a card's
    tensors) sends every tensor through pinned host memory, counted in
    ``staging``."""

    __slots__ = ("ranks", "index", "group", "stage", "staging")

    def __init__(self, ranks: tuple, index: int, group, stage: bool,
                 staging: HostStaging):
        self.ranks, self.index, self.group = tuple(ranks), index, group
        self.stage, self.staging = stage, staging

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return f"AxisGroup(ranks={self.ranks}, index={self.index})"


def _wire(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """``x`` as the backend takes it: contiguous, and on the host (pinned,
    counted) when the group stages."""
    x = x.contiguous()
    if not g.stage:
        return x
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    g.staging.bytes += x.numel() * x.element_size()
    return h


def _empty_wire(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """A receive buffer shaped as ``x`` where the backend takes it."""
    if not g.stage:
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _unwire(h: torch.Tensor, like: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """A received tensor back on ``like``'s device."""
    if not g.stage:
        return h
    g.staging.bytes += h.numel() * h.element_size()
    return h.to(like.device)


def _gather_list(x: torch.Tensor, g: AxisGroup) -> list:
    """Every line member's ``x``, in line order (``x`` itself at this
    rank's index is the received copy, so every rank holds the same
    tensors)."""
    import torch.distributed as dist

    if g.size == 1:
        return [x]
    src = _wire(x, g)
    outs = [_empty_wire(src, g) for _ in range(g.size)]
    dist.all_gather(outs, src, group=g.group)
    return [_unwire(o, x, g) for o in outs]


def _all_to_all_list(pieces: list, g: AxisGroup) -> list:
    """Piece j of this rank to line member j; returns what each member
    sent this rank, in line order. Point to point, one send and one
    receive a peer (gloo has no all-to-all of tensor lists in every
    PyTorch release); this rank's own piece stays where it is."""
    import torch.distributed as dist

    me = g.index
    src = {j: _wire(p, g) for j, p in enumerate(pieces) if j != me}
    outs = {j: _empty_wire(t, g) for j, t in src.items()}
    ops = []
    for j, peer in enumerate(g.ranks):
        if j != me:
            ops.append(dist.P2POp(dist.isend, src[j], peer, group=g.group))
            ops.append(dist.P2POp(dist.irecv, outs[j], peer, group=g.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [pieces[j] if j == me else _unwire(outs[j], pieces[0], g)
            for j in range(g.size)]


def _even_chunks(x: torch.Tensor, n: int, dim: int) -> tuple:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    return x.chunk(n, dim=dim)


def group_all_reduce_sum(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """:func:`all_reduce_sum` over the line: every member's ``x``
    gathered and added member 0 first, the same bits on every rank."""
    return all_reduce_sum(_gather_list(x, g))


def group_all_reduce_max(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """:func:`all_reduce_max` over the line."""
    return all_reduce_max(_gather_list(x, g))


def group_all_gather(x: torch.Tensor, g: AxisGroup, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` over the line: the members' tensors side by side
    along ``dim`` in line order."""
    return all_gather(_gather_list(x, g), dim=dim)


def group_reduce_scatter(x: torch.Tensor, g: AxisGroup,
                         dim: int = 0) -> torch.Tensor:
    """This rank's piece of :func:`reduce_scatter`: piece ``index`` (of
    the line's size along ``dim``) of the sum over the line. Each member
    sends piece j to member j (an all-to-all), and the pieces received are
    added member 0 first."""
    if g.size == 1:
        return x
    return all_reduce_sum(_all_to_all_list(_even_chunks(x, g.size, dim), g))


def group_all_to_all(x: torch.Tensor, g: AxisGroup, split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """This rank's tensor of :func:`all_to_all`: piece j of every member
    (cut along ``split_dim``), member order along ``concat_dim``."""
    if g.size == 1:
        return x
    got = _all_to_all_list(_even_chunks(x, g.size, split_dim), g)
    return torch.cat(got, dim=concat_dim)


def group_ppermute(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """:func:`ppermute` over the line: this rank sends ``x`` to the next
    member and returns the previous member's (point to point)."""
    import torch.distributed as dist

    if g.size == 1:
        return x
    src = _wire(x, g)
    recv = _empty_wire(src, g)
    nxt = g.ranks[(g.index + 1) % g.size]
    prv = g.ranks[(g.index - 1) % g.size]
    ops = [dist.P2POp(dist.isend, src, nxt, group=g.group),
           dist.P2POp(dist.irecv, recv, prv, group=g.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _unwire(recv, x, g)


def group_ring_all_reduce(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """This rank's total of :func:`ring_all_reduce`: n - 1 hops, each
    block added as it passes, in this rank's ring order."""
    acc = blk = x
    for _ in range(g.size - 1):
        blk = group_ppermute(blk, g)
        acc = acc + blk
    return acc


def group_overlapped_sum(x: torch.Tensor, g: AxisGroup,
                         dim: int = -1) -> torch.Tensor:
    """The sum over the line as JAX's overlapped form computes it: a
    reduce-scatter along ``dim`` (the hidden axis), then an all-gather.
    Every element is added member 0 first, so the result is
    :func:`group_all_reduce_sum`'s bit for bit."""
    if g.size == 1:
        return x
    return group_all_gather(group_reduce_scatter(x, g, dim), g, dim)


# ----- the differentiable group forms (the sharded train step) ---------------


class _GatherPieces(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return group_all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return group_reduce_scatter(dy, ctx.g, ctx.dim), None, None


class _SumShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return group_all_reduce_sum(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _EnterShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return group_all_reduce_sum(dy, ctx.g), None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split_dim, concat_dim):
        ctx.g, ctx.dims = g, (split_dim, concat_dim)
        return group_all_to_all(x, g, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, dy):
        split_dim, concat_dim = ctx.dims
        return group_all_to_all(dy, ctx.g, concat_dim, split_dim), None, None, None


def gather_pieces(x: torch.Tensor, g: Optional[AxisGroup],
                  dim: int) -> torch.Tensor:
    """The FSDP gather: the line's pieces side by side along ``dim``;
    the gradient of each piece is the sum over the line of the gathered
    tensor's gradient at its place (the reduce-scatter)."""
    return x if g is None or g.size == 1 else _GatherPieces.apply(x, g, dim)


def sum_shards(x: torch.Tensor, g: Optional[AxisGroup]) -> torch.Tensor:
    """The sum of the line's partial results (a row-parallel product,
    the vocab-parallel lookup and log-sum-exp); every member reads the
    sum and computes the same thing from it, so the gradient of each
    partial is the sum's gradient as it is."""
    return x if g is None or g.size == 1 else _SumShards.apply(x, g)


def enter_shards(x: torch.Tensor, g: Optional[AxisGroup]) -> torch.Tensor:
    """``x``, which every member holds alike, as the input of this
    member's part of a column-parallel product: the value as it is, its
    gradient the sum over the line of the members' partial gradients."""
    return x if g is None or g.size == 1 else _EnterShards.apply(x, g)


def exchange(x: torch.Tensor, g: Optional[AxisGroup], split_dim: int,
             concat_dim: int) -> torch.Tensor:
    """:func:`group_all_to_all` whose gradient goes back by the inverse
    all-to-all."""
    if g is None or g.size == 1:
        return x
    return _Exchange.apply(x, g, split_dim, concat_dim)
