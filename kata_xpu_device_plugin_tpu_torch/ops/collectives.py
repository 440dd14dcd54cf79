"""Collectives over the shards of a tensor-parallel server (counterpart of
``kata_xpu_device_plugin_tpu/ops/collectives.py`` and of the model-axis
collectives GSPMD inserts for tensor-parallel serving there).

A serving mesh of this package keeps every shard on one device
(:class:`..guest.tp_serving.ServingMesh`), so a collective is a plain
function over the list of per-shard tensors, indexed by shard. Each result
is one tensor that every shard reads: on one device the copies a
multi-device collective would leave on each shard are the same tensor.
Sums add the shards in ascending order. JAX's overlapped form of the sum
(a reduce-scatter then an all-gather) hides communication that shards on
one device do not have, so it is not ported here.
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

