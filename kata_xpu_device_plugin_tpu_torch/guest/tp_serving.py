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
checks it at full width; placing shards on distinct GPUs is not ported.

KV layouts: under ``"heads"`` the KV-head axis splits when the KV heads
divide the degree (:func:`kv_heads_shardable`) and replicates otherwise;
under ``"blocks"`` (paged pools only) the pool's token axis splits into
per-shard sub-pools of whole blocks. With every shard on one device a
split is a view of the one physical tensor and a replicated leaf is that
tensor itself, so the KV state is placed once, unsplit. JAX's placement
specs of the KV state (``kv_cache_spec``, ``kv_rows_spec``) and its
overlapped sum across shards act only across devices, and are not ported.

Degraded mode (:func:`shrink_ladder`, :func:`tp_min_from_env`,
:func:`degraded_enabled`): after a permanent fault that names a shard
(an injected ``chip_loss``, or ``ici_error``) the server halves its degree
over the survivors, floored at ``KATA_TPU_TP_MIN``, and re-splits its
parameters at the new degree; ``KATA_TPU_DEGRADED=0`` turns the shrink off.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

from ..constants import ENV_DEGRADED, ENV_KV_LAYOUT, ENV_TP, ENV_TP_MIN
from ..ops import collectives

KV_LAYOUT_HEADS = "heads"
KV_LAYOUT_BLOCKS = "blocks"
KV_LAYOUTS = (KV_LAYOUT_HEADS, KV_LAYOUT_BLOCKS)

__all__ = ["ENV_DEGRADED", "ENV_KV_LAYOUT", "ENV_TP", "ENV_TP_MIN",
           "KV_LAYOUTS", "ServingMesh", "allocation_chips", "degraded_enabled",
           "kv_heads_shardable", "shrink_ladder", "env_degree", "tp_from_env",
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


@dataclass(frozen=True)
class ServingMesh:
    """``tp`` shards of one model on one device. Shard ``s`` holds query
    heads :meth:`q_heads` (``H/tp`` of them) and the matching slices of the
    column- and row-parallel weights (:func:`..parallel.sharding.
    shard_serving_params`); :meth:`reduce` is the sum across shards that
    follows each row-parallel projection."""

    tp: int
    device: torch.device
    n_heads: int
    n_kv_heads: int

    @classmethod
    def for_config(cls, cfg, tp: int, device) -> "ServingMesh":
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        return cls(tp=tp, device=torch.device(device), n_heads=cfg.n_heads,
                   n_kv_heads=cfg.n_kv_heads)

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
