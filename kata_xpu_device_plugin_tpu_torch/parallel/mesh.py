"""Device meshes (counterpart of ``kata_xpu_device_plugin_tpu/parallel/mesh.py``).

The axis names and the default factorization are the JAX package's:

- ``data``  — pure data parallelism;
- ``fsdp``  — data parallelism with parameter and optimizer sharding;
- ``model`` — tensor parallelism (heads, MLP hidden);
- ``seq``   — sequence parallelism (ring or Ulysses attention).

A :class:`Mesh` of this package is a shape over ONE device, as
:class:`..guest.tp_serving.ServingMesh` is for serving: the algorithm of
the parallel axes runs as it would across devices (a ring's hops become a
rotation of per-shard tensors, an all-to-all a reshuffle), so one card
runs and checks it at full width. A port-only difference: a mesh larger
than the devices present places every shard on the first of them (JAX
raises); placing shards on distinct GPUs is not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .. import resolve_device

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"

MESH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_MODEL)


def default_mesh_shape(n_devices: int) -> dict[str, int]:
    """A dp x fsdp x tp factorization: tensor parallelism over the closest
    neighbours (at most 4 ways), FSDP over the rest, pure DP only when the
    device count has leftover factors (the JAX package's rule)."""
    model = 1
    for cand in (4, 2):
        if n_devices % cand == 0 and n_devices >= cand * 2:
            model = cand
            break
    rest = n_devices // model
    fsdp = rest
    data = 1
    if rest % 2 == 0 and rest >= 4:
        data = 2
        fsdp = rest // 2
    return {AXIS_DATA: data, AXIS_FSDP: fsdp, AXIS_MODEL: model}


@dataclass(frozen=True)
class Mesh:
    """Named axes of the given sizes, every shard on ``device``."""

    axis_names: tuple
    dims: tuple
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))


def _devices(devices: Optional[Sequence]) -> list[torch.device]:
    """The caller's devices, else the CUDA devices present (no CUDA and no
    devices raises, as every entry point of this package does)."""
    if devices is None:
        first = resolve_device(None)
        return [first] + [torch.device("cuda", i)
                          for i in range(torch.cuda.device_count())
                          if i != first.index]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


def build_mesh(shape: Optional[dict[str, int]] = None,
               devices: Optional[Sequence] = None,
               axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """A mesh of ``shape`` (default :func:`default_mesh_shape` of the
    devices); the ``seq`` axis joins the axis names when the shape asks for
    it. A shape that covers fewer shards than devices raises, as in JAX;
    one that covers more places every shard on the first device."""
    devices = _devices(devices)
    shape = shape or default_mesh_shape(len(devices))
    if axis_names is None:
        axis_names = MESH_AXES + (
            (AXIS_SEQ,) if shape.get(AXIS_SEQ, 1) > 1 else ())
    dims = tuple(shape.get(a, 1) for a in axis_names)
    if math.prod(dims) < len(devices):
        raise ValueError(f"mesh shape {shape} does not cover {len(devices)} devices")
    return Mesh(tuple(axis_names), dims, devices[0])


def mesh_1d(n: int, axis_name: str,
            devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh of ``n`` shards: the shared constructor of the sequence,
    pipeline and expert axes."""
    if n < 1:
        raise ValueError(f"axis {axis_name!r} needs at least one shard, got {n}")
    return Mesh((axis_name,), (n,), _devices(devices)[0])


def seq_mesh(n_seq: int, devices: Optional[Sequence] = None) -> Mesh:
    """The 1-D mesh of sequence-parallel ring attention."""
    return mesh_1d(n_seq, AXIS_SEQ, devices)
