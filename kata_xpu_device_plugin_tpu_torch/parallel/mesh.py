"""Device meshes (counterpart of ``kata_xpu_device_plugin_tpu/parallel/mesh.py``).

The axis names and the default factorization are the JAX package's:

- ``data``  — pure data parallelism;
- ``fsdp``  — data parallelism with parameter and optimizer sharding;
- ``model`` — tensor parallelism (heads, MLP hidden);
- ``seq``   — sequence parallelism (ring or Ulysses attention);
- ``pipe``  — pipeline stages (:mod:`.pipeline`, :mod:`.composed`);
- ``expert`` — expert parallelism (:mod:`..ops.moe`).

Two kinds of :class:`Mesh`:

- the one-process mesh (:func:`build_mesh` and the 1-D constructors), a
  shape over ONE device, as :class:`..guest.tp_serving.ServingMesh` is
  for serving: the algorithm of the parallel axes runs as it would across
  devices (a ring's hops become a rotation of per-shard tensors, an
  all-to-all a reshuffle), so one card runs and checks it at full width.
  A port-only difference: a mesh larger than the devices present places
  every shard on the first of them (JAX raises);
- the process mesh (:func:`process_mesh`), the PyTorch idiom for shards on
  devices of their own: one shard a process, its shards the ranks of a
  ``torch.distributed`` group (as ``torchrun`` starts them, one a card
  over NCCL; gloo on the CPU or for ranks that share a card). Rank r holds
  shard r's pieces on its own device and every cross-shard step is a real
  collective over one line of an axis (:class:`..ops.collectives.
  AxisGroup`). It covers the axes of the default training mesh, ``data``,
  ``fsdp`` and ``model``; the ``seq``, ``pipe`` and ``expert`` axes over
  processes are not ported yet and raise.
"""
from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from .. import resolve_device

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"

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


@dataclass(frozen=True, eq=False)
class MeshProcesses:
    """The process side of a process mesh: this rank, its coordinate on
    each axis, the default group, its backend, and the line of each axis
    through this rank (plus ``world``, every rank)."""

    rank: int
    coords: tuple
    group: Any
    backend: str
    lines: dict
    world: Any
    staging: Any


@dataclass(frozen=True)
class Mesh:
    """Named axes of the given sizes, every shard on ``device``; with
    ``procs`` a process mesh, this process holding one shard on
    ``device``."""

    axis_names: tuple
    dims: tuple
    device: torch.device
    procs: Optional[MeshProcesses] = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def rank(self) -> int:
        """This process's rank in the default group (0 on a one-process
        mesh)."""
        return 0 if self.procs is None else self.procs.rank

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis (a one-process mesh holds
        every coordinate: None)."""
        if self.procs is None:
            return None
        return dict(zip(self.axis_names, self.procs.coords))

    def line(self, axis: Optional[str] = None):
        """The :class:`..ops.collectives.AxisGroup` of ``axis`` through
        this rank (no axis: every rank of the mesh); None on a
        one-process mesh."""
        if self.procs is None:
            return None
        return self.procs.world if axis is None else self.procs.lines[axis]


def is_process_mesh(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.procs is not None


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


def pipe_mesh(n_stages: int, devices: Optional[Sequence] = None) -> Mesh:
    """The 1-D mesh of pipeline stages (JAX ``pipeline.pipe_mesh``)."""
    return mesh_1d(n_stages, AXIS_PIPE, devices)


def expert_mesh(n: int, devices: Optional[Sequence] = None) -> Mesh:
    """The 1-D mesh of expert parallelism (JAX ``ops.moe.expert_mesh``)."""
    return mesh_1d(n, AXIS_EXPERT, devices)


def composed_mesh(pipe: int, fsdp: int, model: int,
                  devices: Optional[Sequence] = None) -> Mesh:
    """The ``(pipe, fsdp, model)`` mesh of the composed step (JAX
    ``composed.composed_mesh``). Given devices must number at least
    ``pipe·fsdp·model``, as in JAX; without them every shard sits on the
    first CUDA device, as :func:`build_mesh` places a larger mesh."""
    n = pipe * fsdp * model
    if devices is not None:
        devices = list(devices)
        if len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh((AXIS_PIPE, AXIS_FSDP, AXIS_MODEL), (pipe, fsdp, model),
                _devices(devices)[0])


# The axes a process mesh takes, and where the rest stand.
_NOT_OVER_PROCESSES = {
    AXIS_SEQ: "ring and Ulysses attention (parallel/ring.py, ulysses.py)",
    AXIS_PIPE: "the pipeline (parallel/pipeline.py, composed.py)",
    AXIS_EXPERT: "expert dispatch (ops/moe.py moe_ffn_sharded)",
}


def process_mesh(shape: dict[str, int], device=None) -> Mesh:
    """A mesh of ``shape`` over the ranks of the default
    ``torch.distributed`` group, one shard a rank: rank r sits at the
    row-major coordinates of r over the data, fsdp and model axes, the
    order JAX's ``build_mesh`` lays devices out. Every rank calls it with
    the same shape, once: it makes one sub-group for each line of each axis
    (``dist.new_group``), and the group's backend is the caller's (NCCL for
    one rank a card; gloo on the CPU, or for ranks sharing a card, whose
    card tensors then go through pinned host memory). The rank's device is
    ``cuda:LOCAL_RANK`` unless ``device`` names one (ranks sharing one card
    name it; on the CPU, ``"cpu"``).

    A shape whose size is not the world size, an axis other than data,
    fsdp and model (``seq``, ``pipe`` and ``expert`` over processes are not
    ported yet), or no process group raises."""
    import torch.distributed as dist

    from ..ops.collectives import AxisGroup, HostStaging

    for axis, what in _NOT_OVER_PROCESSES.items():
        if shape.get(axis, 1) > 1:
            raise ValueError(f"the {axis!r} axis over processes is not ported "
                             f"yet ({what}); a process mesh takes "
                             f"{MESH_AXES}")
    unknown = set(shape) - set(MESH_AXES) - set(_NOT_OVER_PROCESSES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a process mesh needs a torch.distributed process "
                           "group (guest.distributed.initialize_from_env)")
    group = dist.group.WORLD
    world_size = dist.get_world_size()
    dims = tuple(shape.get(a, 1) for a in MESH_AXES)
    if math.prod(dims) != world_size:
        raise ValueError(f"mesh shape {shape} has {math.prod(dims)} shards "
                         f"but the group has {world_size} ranks")
    rank = dist.get_rank()
    coords = tuple(int(c) for c in _unravel(rank, dims))
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    device = resolve_device(device)
    backend = str(dist.get_backend(group))
    staging = HostStaging()
    stage = backend == "gloo" and device.type == "cuda"
    lines = {}
    for k, axis in enumerate(MESH_AXES):
        # Every rank makes every line's group, in one order (new_group is
        # collective over the default group); each keeps its own line.
        others = [range(n) if j != k else [None] for j, n in enumerate(dims)]
        for fixed in itertools.product(*others):
            ranks = tuple(_ravel(fixed[:k] + (i,) + fixed[k + 1:], dims)
                          for i in range(dims[k]))
            pg = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                lines[axis] = AxisGroup(ranks, ranks.index(rank), pg,
                                        stage, staging)
    world = AxisGroup(tuple(range(world_size)), rank, group, stage, staging)
    procs = MeshProcesses(rank, coords, group, backend, lines, world, staging)
    return Mesh(MESH_AXES, dims, device, procs)


def _unravel(r: int, dims: tuple) -> list:
    out = []
    for n in reversed(dims):
        out.append(r % n)
        r //= n
    return out[::-1]


def _ravel(coords: tuple, dims: tuple) -> int:
    r = 0
    for c, n in zip(coords, dims):
        r = r * n + c
    return r
