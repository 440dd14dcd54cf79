"""Guest-side multi-host initialization from the env the plugin injects
(counterpart of ``kata_xpu_device_plugin_tpu/guest/distributed.py``).

The plugin's CDI edits hand every guest of a multi-host slice a consistent
identity (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``). This module turns
that identity into a ``torch.distributed`` process group: ``nccl`` on
CUDA, ``gloo`` on the CPU, rendezvous at ``tcp://`` worker 0's hostname on
the JAX package's coordinator port. :func:`resolve` keeps the JAX
package's env contract and every one of its refusals; ``dry_run`` reports
what would be passed without starting a group.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ..constants import DEFAULT_COORDINATOR_PORT, ENV_WORKER_HOSTNAMES, ENV_WORKER_ID

__all__ = ["DEFAULT_COORDINATOR_PORT", "DistributedConfig", "initialize_from_env",
           "resolve"]


@dataclass(frozen=True)
class DistributedConfig:
    """Resolved multi-host identity (before the process group starts)."""

    num_processes: int
    process_id: int
    coordinator_address: Optional[str]  # None for single-host: no-op init

    @property
    def multi_host(self) -> bool:
        return self.num_processes > 1


def resolve(env: Optional[dict] = None,
            port: int = DEFAULT_COORDINATOR_PORT) -> DistributedConfig:
    """Derive the process group from the plugin-injected env.

    Worker 0's hostname is the coordinator (every host computes the same
    ordered list, so the choice is consistent without any extra channel).
    Missing/single-host env resolves to a no-op config rather than raising:
    single-host pods must run unmodified.
    """
    env = os.environ if env is None else env
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
        return DistributedConfig(1, 0, None)
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
        num_processes=len(hostnames),
        process_id=worker_id,
        coordinator_address=f"{hostnames[0]}:{port}",
    )


def initialize_from_env(env: Optional[dict] = None,
                        port: int = DEFAULT_COORDINATOR_PORT,
                        dry_run: bool = False, device=None) -> dict:
    """Start the ``torch.distributed`` process group the injected env
    describes; returns a JSON-friendly summary with the JAX package's keys.

    Single-host: no-op. ``dry_run=True`` reports what would be passed
    without starting anything. The backend is ``nccl`` for CUDA (the
    default device) and ``gloo`` for ``device="cpu"``."""
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

    dev = resolve_device(device)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{cfg.coordinator_address}",
        world_size=cfg.num_processes, rank=cfg.process_id)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    summary["initialized"] = True
    summary["global_devices"] = local * cfg.num_processes
    summary["local_devices"] = local
    return summary
