"""Tensor-parallel serving (counterpart of
``kata_xpu_device_plugin_tpu/guest/tp_serving.py``): the degree a guest
serves at, the layouts of its KV state, and the serving mesh.

The degree (:func:`tp_from_env`) resolves as in the JAX package:

1. ``KATA_TPU_TP``, the daemon's override: ``0``/``1`` pin one shard; a
   malformed or negative value degrades to the derived degree.
2. ``TPU_VISIBLE_CHIPS``: the length of the granted chip list.
3. ``TPU_ACCELERATOR_TYPE``: the host-local chip count of the slice type.
4. Neither: 1.

A derived degree above the devices present degrades to 1: the env says
what was allocated, the machine what is real. Those rungs are the TPU
daemon's env names, kept as they are; the device count is the CUDA
devices visible to PyTorch (one, the CPU, without CUDA).

The serving mesh (:class:`ServingMesh`) is ``tp`` shards on ONE device:
the server's device, the card or, in the tests, the CPU. JAX's CPU tests
stand in for chips with forced host devices; this package's counterpart,
and a port-only difference, is that an explicit ``tp=`` larger than the
devices present places every shard on one device. The algorithm of
tensor-parallel serving runs as it would across devices (per-shard
column- and row-parallel weights, the sums across shards, per-shard
attention and the shard-local decode kernel with its merge), so one card
checks it at full width. Shards on devices of their own are ported for
training, one shard a process (``parallel.mesh.process_mesh``); serving
over a process mesh, every rank running the server's loop in lockstep,
is not ported yet, and a server given one raises.

KV layouts: under ``"heads"`` the KV-head axis splits when the KV heads
divide the degree (:func:`kv_heads_shardable`) and replicates otherwise;
under ``"blocks"`` (paged pools only) the pool's token axis splits into
per-shard sub-pools of whole blocks. With every shard on one device a
split is a view of the one physical tensor and a replicated leaf is that
tensor itself, so the KV state is placed once, unsplit;
:func:`kv_cache_spec` names the cut the shards read. JAX's
``kv_rows_spec`` acts only across devices and waits for serving over a
process mesh; its overlapped sum across shards is
``ops.collectives.group_overlapped_sum``, a collective over a process
mesh's line.

Degraded mode (:func:`shrink_ladder`, :func:`tp_min_from_env`,
:func:`degraded_enabled`): after a permanent fault that names a shard
(an injected ``chip_loss``, or ``ici_error``) the server halves its degree
over the survivors, floored at ``KATA_TPU_TP_MIN``, and re-splits its
parameters at the new degree; ``KATA_TPU_DEGRADED=0`` turns the shrink off.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..constants import ENV_DEGRADED, ENV_KV_LAYOUT, ENV_TP, ENV_TP_MIN
from ..ops import collectives

KV_LAYOUT_HEADS = "heads"
KV_LAYOUT_BLOCKS = "blocks"
KV_LAYOUTS = (KV_LAYOUT_HEADS, KV_LAYOUT_BLOCKS)

__all__ = ["ENV_DEGRADED", "ENV_KV_LAYOUT", "ENV_TP", "ENV_TP_MIN",
           "KV_LAYOUTS", "ServingMesh", "allocation_chips", "degraded_enabled",
           "kv_cache_spec", "kv_heads_shardable", "shrink_ladder", "env_degree", "tp_from_env",
           "tp_min_from_env"]

# TPU families: (chips per host, whether the type's suffix counts
# TensorCores, two a chip), the JAX package's topology/slice.py FAMILIES.
_TPU_FAMILIES = {
    "v2": (4, True), "v3": (4, True), "v4": (4, True), "v5p": (4, True),
    "v5litepod": (8, False), "v6e": (8, False),
}


def _topology_chips(env) -> int:
    """The chip count the TPU topology env describes (1 when absent)."""
    raw = env.get("TPU_VISIBLE_CHIPS", "").strip()
    if raw:
        return len([c for c in raw.split(",") if c.strip()]) or 1
    accel = env.get("TPU_ACCELERATOR_TYPE", "").strip()
    if accel:
        name, sep, suffix = accel.partition("-")
        fam = _TPU_FAMILIES.get(name)
        if fam is None or not sep or not suffix.isdigit():
            return 1
        per_host, counts_cores = fam
        chips = int(suffix) // 2 if counts_cores else int(suffix)
        return min(chips, per_host) if chips >= 1 else 1
    return 1


def local_device_count() -> int:
    """The devices a serving mesh could span: the CUDA devices, or the one
    CPU."""
    return max(1, torch.cuda.device_count()) if torch.cuda.is_available() else 1


def env_degree(env: Optional[dict] = None, *, label: str = "",
               trace: str = "") -> int:
    """The degree the env asks for (the module doc's ladder), devices not
    yet counted; a malformed value emits one ``serving/tp_disabled`` event
    and falls to the topology's chips."""
    from .. import obs

    env = os.environ if env is None else env
    raw = env.get(ENV_TP, "").strip()
    tp = None
    if raw:
        try:
            tp = int(raw)
        except ValueError:
            tp = None
        if tp is None or tp < 0:
            obs.emit("serving", "tp_disabled", server=label,
                     reason=f"bad_env:{raw[:32]}",
                     **({"trace": trace} if trace else {}))
            tp = None
        elif tp == 0:
            tp = 1
    return max(1, _topology_chips(env) if tp is None else tp)


def tp_from_env(env: Optional[dict] = None, *,
                device_count: Optional[int] = None, label: str = "",
                trace: str = "") -> int:
    """The serving degree from the env (:func:`env_degree`); always at
    least 1. Every degrade emits one ``serving/tp_disabled`` event with its
    reason, ``server=label`` and (when given) the allocation ``trace``."""
    from .. import obs

    tp = env_degree(env, label=label, trace=trace)
    if tp > 1:
        if device_count is None:
            device_count = local_device_count()
        if tp > device_count:
            obs.emit("serving", "tp_disabled", server=label, tp=tp,
                     reason=f"insufficient_devices:{device_count}",
                     **({"trace": trace} if trace else {}))
            tp = 1
    return tp


def degraded_enabled(env: Optional[dict] = None) -> bool:
    """Is the mesh shrink after a permanent fault allowed?
    ``KATA_TPU_DEGRADED=0`` turns it off; any other value, or none, on."""
    env = os.environ if env is None else env
    return env.get(ENV_DEGRADED, "1") != "0"


def tp_min_from_env(*, label: str = "", trace: str = "") -> int:
    """The shrink ladder's floor, ``KATA_TPU_TP_MIN`` (default 1, at least
    1); a malformed value degrades to 1 with one ``tp_min_invalid``
    event."""
    from . import resilience

    return max(1, resilience.env_int(ENV_TP_MIN, 1, event="tp_min_invalid",
                                     server=label, trace=trace))


def shrink_ladder(tp: int, survivors: int, tp_min: int = 1) -> Optional[int]:
    """The degree after a permanent fault at degree ``tp``: halve until the
    rung fits the ``survivors`` and stays at or above ``tp_min`` (tp=4 ->
    2 -> 1); None when no rung is left, and the load fails loudly."""
    floor = max(1, int(tp_min))
    t = tp // 2
    while t >= floor:
        if t <= survivors:
            return t
        t //= 2
    return None


def allocation_chips(env: Optional[dict] = None) -> str:
    """The daemon-granted chip set this guest serves on: the normalized
    ``TPU_VISIBLE_CHIPS`` list, ``""`` outside an allocation (the JAX
    package's reading; the daemon's grant variable for NVIDIA cards is not
    read yet). Every serving heartbeat carries it, the join key of the
    daemon's per-allocation gauges."""
    env = os.environ if env is None else env
    raw = env.get("TPU_VISIBLE_CHIPS", "").strip()
    return ",".join(c.strip() for c in raw.split(",") if c.strip())


def kv_heads_shardable(cfg, tp: int) -> bool:
    """The one divide-or-replicate decision for serving KV state: the head
    axis splits only when the KV heads divide the degree."""
    return tp > 1 and cfg.n_kv_heads % tp == 0


def kv_cache_spec(cfg, tp: int, layout: str = KV_LAYOUT_HEADS) -> tuple:
    """The partition spec of every serving KV arena layout (JAX
    ``kv_cache_spec``), one entry a dim of ``[L, B|1, S|NT, KV, D]``: the
    KV-head axis (3) over ``model`` when :func:`kv_heads_shardable`, the
    token axis (2) under ``"blocks"`` at ``tp > 1``, else replicated
    (``()``). Every shard here is on one device, so the spec places
    nothing: it says which cut the shards read of the one tensor, and
    whether JAX would hold it once a shard (replicated)."""
    if layout == KV_LAYOUT_BLOCKS:
        return (None, None, "model", None, None) if tp > 1 else ()
    if kv_heads_shardable(cfg, tp):
        return (None, None, None, "model", None)
    return ()


@dataclass(frozen=True)
class ServingMesh:
    """``tp`` shards of one model on one device. Shard ``s`` holds query
    heads :meth:`q_heads` (``H/tp`` of them) and the matching slices of the
    column- and row-parallel weights (:func:`..parallel.sharding.
    shard_serving_params`); :meth:`reduce` is the sum across shards that
    follows each row-parallel projection.

    ``train_mesh``: a caller's training mesh (:meth:`for_mesh`, the
    server's ``mesh=``). The params are then the
    :class:`..parallel.sharding.Sharded` pieces of ``PARAM_RULES`` on it,
    ``tp`` its ``model`` size: each layer gathers its weights over fsdp
    when it runs (:meth:`layer_source`), the embedding is looked up and
    the logits made vocab-parallel (:meth:`embed`, :meth:`unembed`), and a
    fused weight's pieces are cuts of its whole out axis."""

    tp: int
    device: torch.device
    n_heads: int
    n_kv_heads: int
    train_mesh: Any = None

    @classmethod
    def for_config(cls, cfg, tp: int, device) -> "ServingMesh":
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        return cls(tp=tp, device=torch.device(device), n_heads=cfg.n_heads,
                   n_kv_heads=cfg.n_kv_heads)

    @classmethod
    def for_mesh(cls, cfg, mesh) -> "ServingMesh":
        """The serving view of a training mesh: ``tp`` its ``model``
        size, every shard on its device. A process mesh raises: serving
        over processes is not ported yet."""
        if getattr(mesh, "procs", None) is not None:
            raise ValueError("serving over a process mesh is not ported yet "
                             "(every rank running the server's loop in "
                             "lockstep); serve over a one-process mesh")
        return cls(tp=mesh.shape.get("model", 1), device=mesh.device,
                   n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                   train_mesh=mesh)

    def layer_source(self, layers: dict):
        """``i -> [shard m's layer i dict]`` over a training mesh's stacked
        pieces: each call gathers layer ``i``'s weights over fsdp
        (``Sharded.select``) for every model shard, so one layer's
        gathered weights live at a time, never the whole model."""
        from ..parallel.sharding import layer_leaves, local

        stacks = {k: layer_leaves(v) for k, v in layers.items()}
        return lambda i: [{k: local(v[i], model=m) for k, v in stacks.items()}
                          for m in range(self.tp)]

    def embed(self, params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
        """The vocab-parallel lookup (``parallel.spmd.vocab_embed``)."""
        from ..parallel.spmd import vocab_embed

        return vocab_embed(params["embed"], tokens, cfg, self.tp)

    def unembed(self, params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
        """fp32 logits: each model shard's vocab slice (its unembedding
        gathered over fsdp), gathered side by side in vocab order."""
        from ..parallel.spmd import _vocab_logits

        return collectives.all_gather(_vocab_logits(params, x, cfg, self.tp),
                                      dim=-1)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of the column-parallel products: every shard reads
        ``x`` itself."""
        return x

    def gather(self, parts: list) -> torch.Tensor:
        """The shards' column-parallel pieces side by side."""
        from ..models.transformer import _gather

        return _gather(parts)

    def q_heads(self, s: int) -> slice:
        n = self.n_heads // self.tp
        return slice(s * n, (s + 1) * n)

    def kv_heads(self, s: int) -> Optional[slice]:
        """The KV heads shard ``s``'s query heads attend: its own share
        when the KV heads divide the degree; the one KV head its query
        heads all belong to when they do not (every shard then holds every
        KV head, the kv-replicated layout); None when its query heads
        straddle KV heads, and the shard attends with every head."""
        if self.n_kv_heads % self.tp == 0:
            n = self.n_kv_heads // self.tp
            return slice(s * n, (s + 1) * n)
        group = self.n_heads // self.n_kv_heads
        n = self.n_heads // self.tp
        if group % n == 0:
            kv = s * n // group
            return slice(kv, kv + 1)
        return None

    def reduce(self, parts: list) -> torch.Tensor:
        """The sum across shards after a row-parallel projection."""
        return collectives.all_reduce_sum(parts)
