"""PCI id → human-readable resource-name translation (counterpart of
``kata_xpu_device_plugin_tpu/discovery/pciids.py``, the same lookup order).

The reference's ``getDeviceName``/``locateVendor``
(``device_plugin.go:208-275``) seeks through a vendored ``pci.ids`` at
``/usr/pci.ids`` and upper-cases the marketing name into a resource-name
suffix. Here:

- the database path is config, with a ladder of fallbacks (explicit path →
  system locations → the small authored table shipped in ``data/pci.ids``);
- built-in tables name the NVIDIA data-centre GPUs (so a node without a
  database still gets a stable name) and Google's accelerator endpoints
  (absent from the public pci.ids), ahead of any database;
- the parser reads the whole (small) file instead of a byte-seek state machine.
"""
from __future__ import annotations

import os
import re
from typing import Optional

GOOGLE_VENDOR = "1ae0"
NVIDIA_VENDOR = "10de"

# Built-in fallback names for Google accelerator endpoints. Public pci.ids has
# no Cloud TPU device ids, and GKE nodes may not ship a database at all, so
# these guarantee a stable resource name on exactly the hardware we target.
# Generation names follow the TPU_ACCELERATOR_TYPE families.
BUILTIN_GOOGLE_DEVICES = {
    "0027": "TPU_V2",
    "0056": "TPU_V3",
    "005e": "TPU_V4",
    "0062": "TPU_V5P",
    "0063": "TPU_V5E",
    "006f": "TPU_V6E",
}
BUILTIN_GOOGLE_FALLBACK = "TPU"

# Built-in names of NVIDIA data-centre GPUs (the marketing name in the
# public pci.ids brackets, sanitized): the same resource name on every node,
# whatever database it ships.
BUILTIN_NVIDIA_DEVICES = {
    "1eb8": "TESLA_T4",
    "20b0": "A100_SXM4_40GB",
    "20b1": "A100_PCIE_40GB",
    "20b2": "A100_SXM4_80GB",
    "20b5": "A100_PCIE_80GB",
    "20b7": "A30_PCIE",
    "2236": "A10",
    "2322": "H800_PCIE",
    "2324": "H800",
    "2330": "H100_SXM5_80GB",
    "2331": "H100_PCIE",
    "2335": "H200_SXM_141GB",
    "26b5": "L40",
    "26b9": "L40S",
    "27b8": "L4",
}

SYSTEM_PCIIDS_PATHS = (
    "/usr/pci.ids",  # where the reference's image installs it (Dockerfile:66)
    "/usr/share/misc/pci.ids",
    "/usr/share/hwdata/pci.ids",
)

_SANITIZE_RE = re.compile(r"[^A-Za-z0-9_]+")


def sanitize_name(name: str) -> str:
    """Uppercase and restrict to ``[A-Za-z0-9_]`` (ref device_plugin.go:241-251),
    collapsing runs and trimming edges so names are clean resource suffixes."""
    return _SANITIZE_RE.sub("_", name.strip()).strip("_").upper()


class PciIds:
    """Parsed pci.ids database: vendor id → (vendor name, {device id → name})."""

    def __init__(self) -> None:
        self._vendors: dict[str, tuple[str, dict[str, str]]] = {}

    @classmethod
    def parse(cls, text: str) -> "PciIds":
        db = cls()
        current: Optional[str] = None
        for line in text.splitlines():
            if not line or line.lstrip().startswith("#"):
                continue
            if line.startswith("\t\t"):  # subsystem lines — not needed
                continue
            if line.startswith("\t"):
                if current is None:
                    continue
                body = line[1:]
                dev_id, _, dev_name = body.partition("  ")
                dev_id = dev_id.strip().lower()
                if re.fullmatch(r"[0-9a-f]{4}", dev_id):
                    db._vendors[current][1][dev_id] = dev_name.strip()
                continue
            if line[:1].upper() == "C" and line[1:2] == " ":  # device-class section
                current = None
                continue
            ven_id, _, ven_name = line.partition("  ")
            ven_id = ven_id.strip().lower()
            if re.fullmatch(r"[0-9a-f]{4}", ven_id):
                current = ven_id
                db._vendors.setdefault(ven_id, (ven_name.strip(), {}))
            else:
                current = None
        return db

    @classmethod
    def load(cls, path: Optional[str] = None) -> "PciIds":
        """Load from ``path`` if given (errors if it doesn't exist — an
        explicit path silently falling through to a different database would
        ignore the operator's curated names), else the first existing system
        path, else the authored table shipped with the package; else empty."""
        if path:
            with open(path, errors="replace") as f:
                return cls.parse(f.read())
        candidates = list(SYSTEM_PCIIDS_PATHS)
        candidates.append(
            os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "data", "pci.ids")
        )
        for cand in candidates:
            if cand and os.path.isfile(cand):
                try:
                    with open(cand, errors="replace") as f:
                        return cls.parse(f.read())
                except OSError:
                    continue
        return cls()

    def vendor_name(self, vendor: str) -> Optional[str]:
        entry = self._vendors.get(vendor.lower())
        return entry[0] if entry else None

    def device_name(self, vendor: str, device: str) -> Optional[str]:
        entry = self._vendors.get(vendor.lower())
        return entry[1].get(device.lower()) if entry else None


def resource_suffix(vendor: str, device: str, db: Optional[PciIds] = None) -> str:
    """Resource-name suffix for a (vendor, device) pair.

    Resolution order: built-in table (Google accelerators, NVIDIA
    data-centre GPUs) → pci.ids database → raw hex device id (the
    reference's fallback, device_plugin.go:100-103).
    """
    vendor = vendor.lower()
    device = device.lower()
    if vendor == NVIDIA_VENDOR and device in BUILTIN_NVIDIA_DEVICES:
        return BUILTIN_NVIDIA_DEVICES[device]
    if vendor == GOOGLE_VENDOR:
        name = BUILTIN_GOOGLE_DEVICES.get(device)
        if name:
            return name
        if db:
            from_db = db.device_name(vendor, device)
            if from_db:
                return sanitize_name(from_db)
        return BUILTIN_GOOGLE_FALLBACK
    if db:
        from_db = db.device_name(vendor, device)
        if from_db:
            return sanitize_name(from_db)
    return device
