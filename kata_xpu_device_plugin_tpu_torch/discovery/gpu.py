"""NVIDIA GPU discovery (counterpart of
``kata_xpu_device_plugin_tpu/discovery/tpu.py``).

A GPU the ``nvidia`` driver drives is a ``/dev/nvidia<N>`` char device
(major 195, minor N); N is the host-local device id this plugin advertises
and the CDI device name. The driver's shared nodes (``nvidiactl``,
``nvidia-uvm``, ``nvidia-modeset``, ...) are not GPUs: only
``nvidia<digits>`` counts, as the TPU scan keeps ``accel<digits>``.

Which nodes are GPUs, and which PCI function each one is:

- where the driver's procfs is visible, ``<proc>/driver/nvidia/gpus/<BDF>/
  information`` names each GPU's minor ("Device Minor"). Its nodes are the
  GPUs, correlated to their PCI functions by that minor: the minor does not
  have to follow BDF order, so nothing is matched by position. A node whose
  minor the driver does not list (a leftover) is not a GPU;
- where it is hidden, a node is a GPU when the driver answers an
  ``open()`` on it (or is busy: held by someone else). This branch is for
  sandboxed test hosts only (a container that shows neither the driver's
  procfs nor the PCI tree, as a gVisor sandbox does), not for the Kubernetes
  node the daemon serves, where the driver's procfs is always there. Such a
  sandbox that passes one card through can also show nodes of cards it does
  not pass, which answer ``EPERM``; those are not its to hand out. A GPU
  found this way has no PCI identity.

The PCI functions considered are vendor ``10de`` with class 0x0302 (3D
controller) or 0x0300 (VGA); an NVSwitch (class 0x0680) or a GPU's audio
function (0x0403) is not a GPU. A vfio-bound GPU has no ``/dev/nvidia``
node: the VFIO path (:mod:`.vfio`) finds it. Nothing here touches CUDA: a
daemon that opened a context would hold card memory.
"""
from __future__ import annotations

import errno
import os
from dataclasses import dataclass
from typing import Mapping, Optional

from ..cdi import constants as C
from ..multihost.resolver import env_hostnames, from_env
from ..topology.host import HostTopology
from . import sysfs
from .pciids import NVIDIA_VENDOR, PciIds, resource_suffix

# PCI class codes (the top 16 bits of the 24-bit ``class`` file) of a GPU.
GPU_PCI_CLASSES = (0x0302, 0x0300)
NVIDIA_DRIVER = "nvidia"


@dataclass(frozen=True)
class GpuChip:
    """One GPU on the host: its /dev/nvidia node plus optional PCI identity.

    ``index`` (the node's minor number) is the stable host-local device id:
    the CDI device name and the device-plugin device id."""

    index: int
    dev_path: str  # /dev/nvidia<N>
    major: Optional[int] = None
    minor: Optional[int] = None
    pci_address: Optional[str] = None  # normalized BDF, e.g. 0000:19:00.0
    pci_device: Optional[str] = None  # 4 hex digits, e.g. 2330
    numa_node: Optional[int] = None
    iommu_group: Optional[str] = None
    # Upstream PCI path of the function (root complex first, then each
    # bridge): two GPUs behind one switch share a prefix.
    upstream: tuple[str, ...] = ()


@dataclass(frozen=True)
class GpuInventory:
    """Everything discovery learned about this host's GPUs."""

    chips: tuple[GpuChip, ...]
    topology: HostTopology
    model_suffix: str  # resource-name suffix, e.g. "H100_SXM5_80GB"

    @property
    def count(self) -> int:
        return len(self.chips)

    def chip(self, index: int) -> GpuChip:
        for c in self.chips:
            if c.index == index:
                return c
        raise KeyError(index)


def normalize_bdf(bdf: str) -> str:
    """``00000000:19:00.0`` (nvidia-smi's 8-digit domain) and ``0000:19:00.0``
    (sysfs) both become ``0000:19:00.0``; a BDF without a domain gets 0000."""
    bdf = bdf.strip().lower()
    parts = bdf.split(":")
    if len(parts) == 2:
        parts = ["0"] + parts
    if len(parts) != 3:
        raise ValueError(f"malformed PCI address {bdf!r}")
    domain, bus, devfn = parts
    return f"{int(domain, 16):04x}:{int(bus, 16):02x}:{devfn}"


def proc_gpu_minors(proc_root: str = sysfs.DEFAULT_PROC_ROOT) -> Optional[dict[int, str]]:
    """``{minor: BDF}`` from the driver's procfs, or None when the driver's
    GPU directory is not there at all. An entry without a "Device Minor"
    line is left out."""
    base = os.path.join(proc_root, sysfs.NVIDIA_GPUS_SUBDIR)
    try:
        names = sorted(os.listdir(base))
    except OSError:
        return None
    out: dict[int, str] = {}
    for name in names:
        text = sysfs.read_text(os.path.join(base, name, "information")) or ""
        for line in text.splitlines():
            key, _, val = line.partition(":")
            if key.strip() == "Device Minor" and val.strip().isdigit():
                out[int(val.strip())] = normalize_bdf(name)
                break
    return out


def pci_class(sysfs_root: str, address: str) -> Optional[int]:
    """The 16-bit class code of a function (``0x030200`` -> 0x0302)."""
    raw = sysfs.read_text(
        os.path.join(sysfs_root, sysfs.PCI_DEVICES_SUBDIR, address, "class"))
    try:
        return int(raw, 16) >> 8 if raw else None
    except ValueError:
        return None


def upstream_path(sysfs_root: str, address: str) -> tuple[str, ...]:
    """The function's place in the PCI tree: the components of its sysfs
    device path between ``devices/`` and itself."""
    real = os.path.realpath(
        os.path.join(sysfs_root, sysfs.PCI_DEVICES_SUBDIR, address))
    parts = real.split(os.sep)
    if "devices" not in parts or parts[-1] != address:
        return ()
    start = len(parts) - 1 - parts[::-1].index("devices")
    return tuple(parts[start + 1:-1])


def driver_answers(path: str) -> bool:
    """Does the driver serve this node to us (the rule of a host whose
    driver procfs is hidden)? :func:`.sysfs.open_probe` opening it, or
    failing ``EBUSY`` (held elsewhere), says yes; ``EPERM`` or ``EACCES``
    (a card not passed to this sandbox), ``ENXIO`` or ``ENODEV`` (no driver
    behind the inode) and a missing path say no. Health's ``node_alive``
    reads ``EPERM``/``EACCES`` the other way, since a node the plugin has
    already advertised and a guest holds answers so."""
    return sysfs.open_probe(path) in (None, errno.EBUSY)


def scan_gpus(
    sysfs_root: str = sysfs.DEFAULT_SYSFS_ROOT,
    dev_root: str = sysfs.DEFAULT_DEV_ROOT,
    proc_root: str = sysfs.DEFAULT_PROC_ROOT,
    pci_ids: Optional[PciIds] = None,
    env: Optional[Mapping[str, str]] = None,
    resolve_env_identity: bool = True,
) -> GpuInventory:
    """One-shot scan (the manager re-runs it every rescan interval); the
    module doc gives the rules.

    The host's worker identity comes from the node's ``TPU_WORKER_ID`` and
    ``TPU_WORKER_HOSTNAMES`` (``env``, default ``os.environ``), parsed by
    :func:`..multihost.resolver.from_env`. The manager passes
    ``resolve_env_identity=False``: its membership overlay resolves the env
    again with ``--node-name`` and the other sources."""
    minors = proc_gpu_minors(proc_root)
    funcs = {
        f.address: f for f in sysfs.scan_pci(sysfs_root)
        if f.vendor == NVIDIA_VENDOR
        and pci_class(sysfs_root, f.address) in GPU_PCI_CLASSES
    }
    prefix = C.GPU_NODE_PREFIX
    chips = []
    for node in sysfs.scan_char_devices(dev_root, prefix):
        if not node.name[len(prefix):].isdigit():  # nvidiactl, nvidia-uvm, ...
            continue
        index = int(node.name[len(prefix):])
        if minors is None:
            if not driver_answers(node.path):
                continue
            pci = None
        elif index not in minors:
            continue
        else:
            pci = funcs.get(minors[index])
        chips.append(GpuChip(
            index=index,
            dev_path=node.path,
            major=node.major,
            minor=node.minor,
            pci_address=pci.address if pci else None,
            pci_device=pci.device if pci else None,
            numa_node=pci.numa_node if pci else None,
            iommu_group=pci.iommu_group if pci else None,
            upstream=upstream_path(sysfs_root, pci.address) if pci else (),
        ))
    device_id = next((c.pci_device for c in chips if c.pci_device), None)
    suffix = resource_suffix(NVIDIA_VENDOR, device_id, pci_ids) if device_id else "GPU"
    environ = os.environ if env is None else env
    mem = (from_env(environ, hostname=environ.get("HOSTNAME", ""))
           if resolve_env_identity else None)
    # When no id is derivable the peer list still passes through (worker 0),
    # so a direct caller still sees the node's membership.
    hostnames = (mem.hostnames if mem
                 else env_hostnames(environ) if resolve_env_identity else ())
    topo = HostTopology.from_chips(chips, worker_id=mem.worker_id if mem else 0,
                                   worker_hostnames=hostnames)
    return GpuInventory(chips=tuple(chips), topology=topo, model_suffix=suffix)
