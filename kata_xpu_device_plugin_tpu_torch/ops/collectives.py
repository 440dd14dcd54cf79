"""Collectives over the shards of a mesh (counterpart of
``kata_xpu_device_plugin_tpu/ops/collectives.py`` and of the collectives
GSPMD and ``shard_map`` insert there: the model-axis sums of
tensor-parallel serving, the ``seq`` axis's neighbour hop, gather and
all-to-all).

A mesh of this package keeps every shard on one device
(:class:`..guest.tp_serving.ServingMesh`, :class:`..parallel.mesh.Mesh`),
so a collective is a plain function over the list of per-shard tensors,
indexed by shard. A reduction's result is one tensor that every shard
reads: on one device the copies a multi-device collective would leave on
each shard are the same tensor. Sums add the shards in ascending order.
JAX's overlapped form of the sum (a reduce-scatter then an all-gather)
hides communication that shards on one device do not have, so it is not
ported here.
"""
from __future__ import annotations

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
