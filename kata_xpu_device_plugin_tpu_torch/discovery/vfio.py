"""Generalized VFIO passthrough discovery (counterpart of
``kata_xpu_device_plugin_tpu/discovery/vfio.py``, the same semantics).

The reference's entire discovery, kept as the *generalized* second path:
walk PCI functions, keep those bound to ``vfio-pci``
whose vendor is in the configured vendor table (the reference hardcodes
``10de``; ``device_plugin.go:19,149``), and group them by IOMMU group — the
co-allocation unit for whole-VM passthrough (a group's functions share an
IOMMU domain and must move together into the guest).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from . import sysfs
from .pciids import PciIds, resource_suffix

VFIO_DRIVER = "vfio-pci"


@dataclass(frozen=True)
class VfioDevice:
    """One vfio-bound PCI function (ref ``NvidiaGpuDevice{addr,index}``,
    device_plugin.go:24-28 — but keyed by address, not a global counter)."""

    address: str
    vendor: str
    device: str
    iommu_group: str
    numa_node: int | None = None

    @property
    def vfio_node(self) -> str:
        return f"/dev/vfio/{self.iommu_group}"


@dataclass
class VfioInventory:
    """IOMMU-group-keyed view of vfio-bound devices.

    ``groups``: group id → functions in the group (ref ``iommuMap``,
    device_plugin.go:31). ``models``: (vendor, device) → group ids containing
    that model (ref ``deviceMap``, :34 — one plugin is spawned per model).
    """

    groups: dict[str, list[VfioDevice]] = field(default_factory=dict)
    models: dict[tuple[str, str], list[str]] = field(default_factory=dict)

    def model_suffix(self, key: tuple[str, str], db: PciIds | None = None) -> str:
        return resource_suffix(key[0], key[1], db)


def scan_vfio(
    sysfs_root: str = sysfs.DEFAULT_SYSFS_ROOT,
    vendors: tuple[str, ...] = (),
) -> VfioInventory:
    """Build the inventory; ``vendors`` empty means accept every vendor
    (vendor-table-driven rather than hardcoded)."""
    inv = VfioInventory()
    for f in sysfs.scan_pci(sysfs_root):
        if f.driver != VFIO_DRIVER or f.iommu_group is None:
            continue
        if vendors and f.vendor not in vendors:
            continue
        if f.vendor is None or f.device is None:
            continue
        dev = VfioDevice(
            address=f.address,
            vendor=f.vendor,
            device=f.device,
            iommu_group=f.iommu_group,
            numa_node=f.numa_node,
        )
        inv.groups.setdefault(f.iommu_group, []).append(dev)
        key = (f.vendor, f.device)
        if f.iommu_group not in inv.models.setdefault(key, []):
            inv.models[key].append(f.iommu_group)
    return inv
