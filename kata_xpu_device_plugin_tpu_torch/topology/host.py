"""The GPU host's topology (counterpart of
``kata_xpu_device_plugin_tpu/topology/slice.py``).

A TPU host is a fixed ICI grid whose chips only co-allocate as axis-aligned
boxes; the GPUs of an NVIDIA host are interchangeable as far as the guest's
serving mesh is concerned: any count is a valid request, and what placement
can still improve is locality (the NUMA node, the PCI bridge; see
:mod:`.preferred`). So this model is the GPU count, each GPU's NUMA node and
the host's multi-host identity, and :func:`runtime_env` is the env the guest
reads. Left out, as TPU-only: accelerator-type strings, ICI host bounds,
``TPU_SKIP_MDS_QUERY`` and slice-shaped request counts. NVLink peers are
not modeled yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..cdi import constants as C


@dataclass(frozen=True)
class HostTopology:
    """The GPUs of one host and the host's place among its workers."""

    gpu_count: int
    # NUMA node of each GPU, in device-id order (None: not reported).
    numa_nodes: tuple[Optional[int], ...] = ()
    worker_id: int = 0
    worker_hostnames: tuple[str, ...] = ()

    @classmethod
    def from_chips(cls, chips: Sequence, worker_id: int = 0,
                   worker_hostnames: Sequence[str] = ()) -> "HostTopology":
        return cls(
            gpu_count=len(chips),
            numa_nodes=tuple(c.numa_node for c in chips),
            worker_id=worker_id,
            worker_hostnames=tuple(worker_hostnames),
        )

    @property
    def num_hosts(self) -> int:
        return max(1, len(self.worker_hostnames))


def runtime_env(topo: HostTopology) -> dict[str, str]:
    """The host's static env a guest reads: its worker identity
    (``guest/distributed.py``). The per-allocation grant
    (``TPU_VISIBLE_CHIPS``) is the allocator's."""
    env = {C.ENV_WORKER_ID: str(topo.worker_id)}
    if topo.worker_hostnames:
        env[C.ENV_WORKER_HOSTNAMES] = ",".join(topo.worker_hostnames)
    return env
