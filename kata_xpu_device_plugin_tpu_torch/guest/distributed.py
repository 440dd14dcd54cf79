"""Guest-side multi-host initialization from the env the plugin injects
(counterpart of ``kata_xpu_device_plugin_tpu/guest/distributed.py``).

The plugin's CDI edits hand every guest of a multi-host slice a consistent
identity (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``). This module turns
that identity into a ``torch.distributed`` process group: ``nccl`` on
CUDA, ``gloo`` on the CPU (or the caller's backend), rendezvous at
``tcp://`` worker 0's hostname on the JAX package's coordinator port.
:func:`resolve` keeps the JAX package's env contract and every one of its
refusals; ``dry_run`` reports what would be passed without starting a
group.

One process a card, the PyTorch idiom: a guest with several cards runs
``LOCAL_WORLD_SIZE`` processes under ``torchrun``, which sets
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``. Where they are set, a process's
global rank is worker id x processes a host + ``LOCAL_RANK`` and the world
is hosts x processes a host; where they are not, one process a host, as in
the JAX package. Each process owns one device, so the global devices are
the world's processes.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ..constants import DEFAULT_COORDINATOR_PORT, ENV_WORKER_HOSTNAMES, ENV_WORKER_ID

# torchrun's names for a process's place on its host.
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"

__all__ = ["DEFAULT_COORDINATOR_PORT", "ENV_LOCAL_RANK", "ENV_LOCAL_WORLD_SIZE",
           "DistributedConfig", "initialize_from_env", "resolve"]


@dataclass(frozen=True)
class DistributedConfig:
    """Resolved multi-host identity (before the process group starts)."""

    num_processes: int
    process_id: int
    coordinator_address: Optional[str]  # None for one process: no-op init
    local_rank: int = 0
    local_world: int = 1

    @property
    def multi_host(self) -> bool:
        return self.num_processes > 1


def resolve(env: Optional[dict] = None,
            port: int = DEFAULT_COORDINATOR_PORT) -> DistributedConfig:
    """Derive the process group from the plugin-injected env.

    Worker 0's hostname is the coordinator (every host computes the same
    ordered list, so the choice is consistent without any extra channel;
    ``localhost`` when one host runs several processes with no list).
    Missing/single-host env with one process a host resolves to a no-op
    config rather than raising: single-host pods must run unmodified.
    """
    env = os.environ if env is None else env
    local_rank, local_world = _local_place(env)
    hostnames = [h for h in env.get(ENV_WORKER_HOSTNAMES, "").split(",") if h]
    if len(hostnames) <= 1:
        # Fail closed on the inverse contradiction too: a nonzero worker id
        # with no multi-host hostname list means THIS pod lost its list; if
        # it silently ran single-host, its slice peers would hang waiting
        # for it. (id=0 + no list is plain single-host.)
        raw_id = env.get(ENV_WORKER_ID, "")
        if raw_id.strip() and raw_id.strip() != "0":
            raise ValueError(
                f"TPU_WORKER_ID={raw_id} names a multi-host worker but "
                "TPU_WORKER_HOSTNAMES is missing/single — refusing to run "
                "single-host while slice peers wait"
            )
        if local_world == 1:
            return DistributedConfig(1, 0, None)
        host = hostnames[0] if hostnames else "localhost"
        return DistributedConfig(local_world, local_rank, f"{host}:{port}",
                                 local_rank, local_world)
    try:
        worker_id = int(env.get(ENV_WORKER_ID, ""))
    except ValueError:
        raise ValueError(
            "TPU_WORKER_HOSTNAMES names a multi-host slice but TPU_WORKER_ID "
            "is missing/malformed — the plugin injects both together; "
            "refusing to guess a process id"
        )
    if not 0 <= worker_id < len(hostnames):
        raise ValueError(
            f"TPU_WORKER_ID={worker_id} out of range for "
            f"{len(hostnames)} worker hostnames"
        )
    return DistributedConfig(
        num_processes=len(hostnames) * local_world,
        process_id=worker_id * local_world + local_rank,
        coordinator_address=f"{hostnames[0]}:{port}",
        local_rank=local_rank,
        local_world=local_world,
    )


def _local_place(env) -> tuple:
    """``(LOCAL_RANK, LOCAL_WORLD_SIZE)``, ``(0, 1)`` where unset; a
    malformed or out-of-range pair raises (a process that guessed its place
    would collide with a peer)."""
    raw_rank = env.get(ENV_LOCAL_RANK, "").strip()
    raw_world = env.get(ENV_LOCAL_WORLD_SIZE, "").strip()
    try:
        rank = int(raw_rank) if raw_rank else 0
        world = int(raw_world) if raw_world else 1
    except ValueError:
        raise ValueError(f"LOCAL_RANK={raw_rank!r} / LOCAL_WORLD_SIZE="
                         f"{raw_world!r} are not integers")
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"LOCAL_RANK={rank} out of range for "
                         f"LOCAL_WORLD_SIZE={world}")
    return rank, world


def initialize_from_env(env: Optional[dict] = None,
                        port: int = DEFAULT_COORDINATOR_PORT,
                        dry_run: bool = False, device=None,
                        backend: Optional[str] = None) -> dict:
    """Start the ``torch.distributed`` process group the injected env
    describes; returns a JSON-friendly summary with the JAX package's keys.

    One process: no-op. ``dry_run=True`` reports what would be passed
    without starting anything. The device is ``cuda:LOCAL_RANK`` unless
    ``device`` names one (processes sharing a card name it; ``"cpu"`` for
    the CPU). The backend is the caller's, else ``nccl`` for CUDA and
    ``gloo`` for the CPU; a backend's failure is not caught."""
    import torch

    from .. import resolve_device

    cfg = resolve(env, port)
    summary = {
        "multi_host": cfg.multi_host,
        "num_processes": cfg.num_processes,
        "process_id": cfg.process_id,
        "coordinator_address": cfg.coordinator_address,
        "initialized": False,
    }
    if dry_run or not cfg.multi_host:
        return summary
    import torch.distributed as dist

    if device is None and torch.cuda.is_available():
        device = f"cuda:{cfg.local_rank}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{cfg.coordinator_address}",
        world_size=cfg.num_processes, rank=cfg.process_id)
    summary["initialized"] = True
    summary["global_devices"] = cfg.num_processes
    summary["local_devices"] = 1
    return summary
