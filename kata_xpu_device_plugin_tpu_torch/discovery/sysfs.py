"""sysfs/devfs access primitives (counterpart of
``kata_xpu_device_plugin_tpu/discovery/sysfs.py``; ``scan_pci`` and
``scan_char_devices`` unchanged).

The reference's raw file helpers (``device_plugin.go:183-206``:
``readIDFromFile`` strips the ``0x`` prefix, ``readLink`` takes the basename
of the symlink target) are swappable package-level function vars for
testability; here the same seam is the ``sysfs_root`` / ``dev_root`` /
``proc_root`` parameters, so tests point discovery at a tempdir fake tree.
"""
from __future__ import annotations

import errno
import os
import shutil
import stat
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_SYSFS_ROOT = "/sys"
DEFAULT_DEV_ROOT = "/dev"
DEFAULT_PROC_ROOT = "/proc"

PCI_DEVICES_SUBDIR = "bus/pci/devices"
ACCEL_CLASS_SUBDIR = "class/accel"
# The NVIDIA driver's per-GPU procfs entries: <proc>/driver/nvidia/gpus/<BDF>/
# information lists the GPU's "Device Minor" and "Bus Location".
NVIDIA_GPUS_SUBDIR = "driver/nvidia/gpus"


def read_id_file(path: str) -> Optional[str]:
    """Read a sysfs id file (``vendor``/``device``), normalizing ``0x1ae0`` -> ``1ae0``."""
    try:
        with open(path) as f:
            val = f.read().strip().lower()
    except OSError:
        return None
    return val[2:] if val.startswith("0x") else val


def read_link_base(path: str) -> Optional[str]:
    """Basename of a sysfs symlink target (``driver`` -> ``vfio-pci``,
    ``iommu_group`` -> group id)."""
    try:
        return os.path.basename(os.readlink(path))
    except OSError:
        return None


def read_text(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def open_probe(path: str) -> Optional[int]:
    """The one probe of a device node: a non-blocking ``open()``, closed at
    once. None when it opens, else its errno, which each caller classifies
    (discovery's ``gpu.driver_answers``, health's ``node_alive``). A path
    that is not a char device (a sysfs entry, a fake tree's plain file) is
    not opened: existence is its signal. A path that cannot be stat'ed
    gives ``ENOENT``."""
    try:
        st = os.stat(path)
    except OSError:
        return errno.ENOENT
    if not stat.S_ISCHR(st.st_mode):
        return None
    try:
        fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK | os.O_CLOEXEC)
    except OSError as e:
        return e.errno
    os.close(fd)
    return None


@dataclass(frozen=True)
class PciFunction:
    """One PCI function under ``<sysfs>/bus/pci/devices`` (the unit the
    reference walks; ``device_plugin.go:132-180``)."""

    address: str  # e.g. "0000:00:05.0"
    vendor: Optional[str]  # 4-hex-digit, lowercase, no 0x
    device: Optional[str]
    driver: Optional[str]  # bound kernel driver name, or None
    iommu_group: Optional[str]  # group id as string, or None
    numa_node: Optional[int] = None

    @property
    def bdf(self) -> str:
        return self.address


def scan_pci(sysfs_root: str = DEFAULT_SYSFS_ROOT) -> list[PciFunction]:
    """Enumerate all PCI functions, sorted by address for deterministic output.

    The reference's ``filepath.Walk`` over ``/sys/bus/pci/devices``
    (``device_plugin.go:126-180``) with the vendor filter *removed* — filtering
    is the caller's job (vendor-table-driven), not baked in.
    """
    base = os.path.join(sysfs_root, PCI_DEVICES_SUBDIR)
    try:
        entries = sorted(os.listdir(base))
    except OSError:
        return []
    out: list[PciFunction] = []
    for addr in entries:
        devdir = os.path.join(base, addr)
        if not os.path.isdir(devdir):
            continue
        numa = read_text(os.path.join(devdir, "numa_node"))
        out.append(
            PciFunction(
                address=addr,
                vendor=read_id_file(os.path.join(devdir, "vendor")),
                device=read_id_file(os.path.join(devdir, "device")),
                driver=read_link_base(os.path.join(devdir, "driver")),
                iommu_group=read_link_base(os.path.join(devdir, "iommu_group")),
                numa_node=int(numa) if numa not in (None, "", "-1") else None,
            )
        )
    return out


@dataclass(frozen=True)
class CharDevice:
    """A character device node (``/dev/accel<N>`` or ``/dev/vfio/<group>``)."""

    path: str
    major: Optional[int] = None
    minor: Optional[int] = None

    @property
    def name(self) -> str:
        return os.path.basename(self.path)


def scan_char_devices(dev_root: str, prefix: str) -> list[CharDevice]:
    """List char devices directly under ``dev_root`` whose name starts with
    ``prefix`` (e.g. ``accel``), sorted by the numeric suffix when present.

    In tests the fake ``/dev`` holds regular files; those are accepted (no
    mknod in CI), with major/minor only populated for real char devices.
    """
    try:
        names = os.listdir(dev_root)
    except OSError:
        return []
    found: list[CharDevice] = []
    for name in names:
        if not name.startswith(prefix):
            continue
        path = os.path.join(dev_root, name)
        try:
            st = os.stat(path)
        except OSError:
            continue
        if stat.S_ISDIR(st.st_mode):
            continue
        if stat.S_ISCHR(st.st_mode):
            found.append(
                CharDevice(path=path, major=os.major(st.st_rdev), minor=os.minor(st.st_rdev))
            )
        else:
            found.append(CharDevice(path=path))

    def sort_key(d: CharDevice):
        suffix = d.name[len(prefix):]
        return (0, int(suffix)) if suffix.isdigit() else (1, suffix)

    return sorted(found, key=sort_key)


@dataclass
class FakeSysfsBuilder:
    """Helper for building fake sysfs/dev/proc trees in tests (discovery
    against a tempdir fake tree). Lives in the package (not tests/) so
    downstream users get the same harness."""

    root: str
    _groups: set = field(default_factory=set)

    @property
    def sysfs(self) -> str:
        return os.path.join(self.root, "sys")

    @property
    def dev(self) -> str:
        return os.path.join(self.root, "dev")

    @property
    def proc(self) -> str:
        return os.path.join(self.root, "proc")

    def add_pci_function(
        self,
        address: str,
        vendor: str,
        device: str,
        driver: Optional[str] = None,
        iommu_group: Optional[str] = None,
        numa_node: Optional[int] = None,
        pci_class: Optional[str] = None,
        bridges: tuple[str, ...] = (),
    ) -> str:
        """A PCI function. ``pci_class`` writes the ``class`` file (e.g.
        ``"0x030200"``); ``bridges`` places the function below that chain of
        upstream bridges under ``sys/devices`` (``bus/pci/devices/<address>``
        then links there, as on a real host)."""
        devdir = os.path.join(self.sysfs, PCI_DEVICES_SUBDIR, address)
        if bridges:
            real = os.path.join(self.sysfs, "devices", *bridges, address)
            os.makedirs(real, exist_ok=True)
            os.makedirs(os.path.dirname(devdir), exist_ok=True)
            if not os.path.islink(devdir):
                os.symlink(real, devdir)
        os.makedirs(devdir, exist_ok=True)
        with open(os.path.join(devdir, "vendor"), "w") as f:
            f.write(f"0x{vendor}\n")
        with open(os.path.join(devdir, "device"), "w") as f:
            f.write(f"0x{device}\n")
        if pci_class is not None:
            with open(os.path.join(devdir, "class"), "w") as f:
                f.write(f"{pci_class}\n")
        if numa_node is not None:
            with open(os.path.join(devdir, "numa_node"), "w") as f:
                f.write(f"{numa_node}\n")
        if driver:
            drv_dir = os.path.join(self.sysfs, "bus/pci/drivers", driver)
            os.makedirs(drv_dir, exist_ok=True)
            _force_symlink(drv_dir, os.path.join(devdir, "driver"))
        if iommu_group is not None:
            grp_dir = os.path.join(self.sysfs, "kernel/iommu_groups", iommu_group)
            os.makedirs(grp_dir, exist_ok=True)
            _force_symlink(grp_dir, os.path.join(devdir, "iommu_group"))
            if iommu_group not in self._groups:
                self._groups.add(iommu_group)
                self.add_dev_node(f"vfio/{iommu_group}")
        return devdir

    def add_dev_node(self, rel_path: str) -> str:
        path = os.path.join(self.dev, rel_path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("")
        return path

    def add_accel_chip(self, index: int) -> str:
        """A TPU chip: /dev/accel<N> plus its /sys/class/accel entry."""
        node = self.add_dev_node(f"accel{index}")
        class_dir = os.path.join(self.sysfs, ACCEL_CLASS_SUBDIR, f"accel{index}")
        os.makedirs(class_dir, exist_ok=True)
        return node

    def add_nvidia_gpu(
        self,
        minor: int,
        address: Optional[str] = None,
        device: str = "2330",
        numa_node: Optional[int] = None,
        iommu_group: Optional[str] = None,
        driver: str = "nvidia",
        bridges: tuple[str, ...] = (),
        proc_minor: bool = True,
    ) -> str:
        """An NVIDIA GPU driven by ``nvidia``: /dev/nvidia<minor>, its PCI
        function (vendor 10de, class 0x0302) when ``address`` is given, and
        the driver's procfs entry naming its minor (``proc_minor=False``
        leaves the "Device Minor" line out). Returns the dev node."""
        node = self.add_dev_node(f"nvidia{minor}")
        if address is not None:
            self.add_pci_function(
                address, "10de", device, driver=driver, iommu_group=iommu_group,
                numa_node=numa_node, pci_class="0x030200", bridges=bridges,
            )
            gpu_dir = os.path.join(self.proc, NVIDIA_GPUS_SUBDIR, address)
            os.makedirs(gpu_dir, exist_ok=True)
            lines = ["Model: \t\t NVIDIA H100 80GB HBM3", "Bus Type: \t PCIe"]
            if proc_minor:
                lines.append(f"Device Minor: \t {minor}")
            lines.append(f"Bus Location: \t {address}")
            with open(os.path.join(gpu_dir, "information"), "w") as f:
                f.write("\n".join(lines) + "\n")
        return node

    def unbind_driver(self, address: str) -> None:
        """What a driver unbind leaves: the function's ``driver`` link and
        the driver's procfs entry gone, the /dev node lingering."""
        try:
            os.unlink(os.path.join(self.sysfs, PCI_DEVICES_SUBDIR, address, "driver"))
        except FileNotFoundError:
            pass
        shutil.rmtree(os.path.join(self.proc, NVIDIA_GPUS_SUBDIR, address),
                      ignore_errors=True)

    def remove_dev_node(self, rel_path: str) -> None:
        try:
            os.unlink(os.path.join(self.dev, rel_path))
        except FileNotFoundError:
            pass


def _force_symlink(target: str, link: str) -> None:
    try:
        os.unlink(link)
    except FileNotFoundError:
        pass
    os.symlink(target, link)
