"""Device discovery: NVIDIA GPUs (/dev/nvidia* + vendor 10de) and the
generalized VFIO path, plus pci.ids naming (counterpart of
``kata_xpu_device_plugin_tpu/discovery`` and of the reference's
``pkg/device_plugin/device_plugin.go`` discovery layer)."""
from .gpu import GpuChip, GpuInventory, normalize_bdf, scan_gpus
from .pciids import GOOGLE_VENDOR, NVIDIA_VENDOR, PciIds, resource_suffix, sanitize_name
from .sysfs import CharDevice, FakeSysfsBuilder, PciFunction, scan_char_devices, scan_pci
from .vfio import VfioDevice, VfioInventory, scan_vfio

__all__ = [
    "GOOGLE_VENDOR",
    "NVIDIA_VENDOR",
    "PciIds",
    "resource_suffix",
    "sanitize_name",
    "CharDevice",
    "FakeSysfsBuilder",
    "PciFunction",
    "scan_char_devices",
    "scan_pci",
    "GpuChip",
    "GpuInventory",
    "normalize_bdf",
    "scan_gpus",
    "VfioDevice",
    "VfioInventory",
    "scan_vfio",
]
