"""Multi-host membership of the GPU daemon (counterpart of
``kata_xpu_device_plugin_tpu/multihost/``).

Several hosts, each running its own daemon in its own DaemonSet pod, must
hand their Kata guests one consistent view of the job: the same ordered
``TPU_WORKER_HOSTNAMES`` everywhere and a unique ``TPU_WORKER_ID`` per
host, from which ``guest/distributed.py`` forms the guests' process group.
There is no coordinator and the identity must survive pod restarts, so the
worker id is a pure function of stable inputs (the hostname list every host
reads from the same flags, env or metadata), and what resolves is persisted.

JAX's ``multislice_env`` is not ported: the ``MEGASCALE_*`` env it injects
is read only by libtpu's transport between TPU slices. On GPUs that role is
the NCCL group ``guest/distributed.py`` forms over the same worker list.
"""
from .resolver import (
    SliceMembership,
    canonical_order,
    parse_worker_network_endpoints,
    resolve_membership,
)

__all__ = [
    "SliceMembership",
    "canonical_order",
    "parse_worker_network_endpoints",
    "resolve_membership",
]
