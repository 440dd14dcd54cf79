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
specs of the KV state (``kv_cache_spec``, ``kv_rows_spec``), its
overlapped sum across shards and its degraded mesh shrink
(``KATA_TPU_TP_MIN``, ``KATA_TPU_DEGRADED``) act only across devices or
after a fault, and are not ported.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

from ..constants import ENV_KV_LAYOUT, ENV_TP
from ..ops import collectives

KV_LAYOUT_HEADS = "heads"
KV_LAYOUT_BLOCKS = "blocks"
KV_LAYOUTS = (KV_LAYOUT_HEADS, KV_LAYOUT_BLOCKS)

__all__ = ["ENV_KV_LAYOUT", "ENV_TP", "KV_LAYOUTS", "ServingMesh",
           "kv_heads_shardable", "tp_from_env"]

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


def tp_from_env(env: Optional[dict] = None, *,
                device_count: Optional[int] = None) -> int:
    """The serving degree from the env (the module doc's ladder); always at
    least 1."""
    env = os.environ if env is None else env
    raw = env.get(ENV_TP, "").strip()
    tp = None
    if raw:
        try:
            tp = int(raw)
        except ValueError:
            tp = None
        else:
            if tp < 0:
                tp = None
            elif tp == 0:
                tp = 1
    if tp is None:
        tp = _topology_chips(env)
    if tp > 1:
        if device_count is None:
            device_count = local_device_count()
        if tp > device_count:
            tp = 1
    return max(1, tp)


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
