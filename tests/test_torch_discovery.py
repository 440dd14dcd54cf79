"""PyTorch port, host daemon: discovery against fake sysfs/dev/proc trees.
On one fake host, ``scan_pci``, ``scan_char_devices``, ``scan_vfio`` and the
pci.ids lookups give the JAX package's results; ``scan_gpus`` finds the
``/dev/nvidia<N>`` GPUs the driver lists, correlated by minor (not by BDF
order), past a missing node, a procfs entry without a minor, the driver's
shared nodes, an NVSwitch, an audio function and a vfio-bound GPU; with the
driver's procfs hidden it keeps the nodes the driver answers on. Then the
host topology, its env, and the locality-aware preferred allocation."""
from __future__ import annotations

import dataclasses
import errno
import os
import stat as stat_mod

import pytest

from kata_xpu_device_plugin_tpu.discovery import pciids as jpciids
from kata_xpu_device_plugin_tpu.discovery import sysfs as jsysfs
from kata_xpu_device_plugin_tpu.discovery import vfio as jvfio
from kata_xpu_device_plugin_tpu_torch.cdi import constants as C
from kata_xpu_device_plugin_tpu_torch.discovery import (
    gpu,
    normalize_bdf,
    pciids,
    scan_gpus,
    scan_vfio,
    sysfs,
)
from kata_xpu_device_plugin_tpu_torch.topology import (
    HostTopology,
    choose_chips,
    runtime_env,
)


@pytest.fixture
def fake(tmp_path):
    return sysfs.FakeSysfsBuilder(root=str(tmp_path))


def mixed_host(fake):
    """GPUs whose minors do not follow BDF order, an NVSwitch, a GPU's audio
    function, vfio-bound functions in shared groups, a TPU-style accel chip,
    the driver's shared nodes and strays."""
    fake.add_nvidia_gpu(0, "0000:b8:00.0", numa_node=1, iommu_group="40")
    fake.add_nvidia_gpu(1, "0000:19:00.0", numa_node=0, iommu_group="10")
    fake.add_nvidia_gpu(2, "0000:3b:00.0", numa_node=0, iommu_group="20")
    fake.add_pci_function("0000:3b:00.1", "10de", "22ba", driver="snd_hda_intel",
                          iommu_group="20", pci_class="0x040300")
    fake.add_pci_function("0000:07:00.0", "10de", "22a3", numa_node=0,
                          pci_class="0x068000")  # NVSwitch
    fake.add_pci_function("0000:5d:00.0", "10de", "2330", driver="vfio-pci",
                          iommu_group="30", numa_node=0, pci_class="0x030200")
    fake.add_pci_function("0000:5d:00.1", "10de", "22ba", driver="vfio-pci",
                          iommu_group="30", pci_class="0x040300")
    fake.add_pci_function("0000:04:00.0", "1ae0", "0063", driver="vfio-pci",
                          iommu_group="7")
    fake.add_pci_function("0000:00:05.0", "8086", "10fb", driver="ixgbe")
    fake.add_accel_chip(0)
    for name in (*C.SHARED_NODES, "nvidia-modeset", "nvidia-caps"):
        fake.add_dev_node(name)
    return fake


def _fields(objs):
    return [dataclasses.astuple(o) for o in objs]


def test_scans_and_lookups_match_jax(fake):
    mixed_host(fake)
    assert _fields(sysfs.scan_pci(fake.sysfs)) == _fields(jsysfs.scan_pci(fake.sysfs))
    for prefix in ("nvidia", "accel", "vfio", ""):
        assert (_fields(sysfs.scan_char_devices(fake.dev, prefix))
                == _fields(jsysfs.scan_char_devices(fake.dev, prefix)))
    for vendors in ((), ("10de",), ("1ae0",), ("10de", "8086")):
        got, want = scan_vfio(fake.sysfs, vendors), jvfio.scan_vfio(fake.sysfs, vendors)
        assert {g: _fields(d) for g, d in got.groups.items()} == {
            g: _fields(d) for g, d in want.groups.items()}
        assert got.models == want.models
    for ident in ("0000:00:05.0", "0000:3b:00.0"):
        assert (sysfs.read_id_file(os.path.join(fake.sysfs, sysfs.PCI_DEVICES_SUBDIR,
                                                ident, "vendor"))
                == jsysfs.read_id_file(os.path.join(fake.sysfs, jsysfs.PCI_DEVICES_SUBDIR,
                                                    ident, "vendor")))


PCI_DB = (
    "# comment\n"
    "10de  NVIDIA Corporation\n"
    "\t2203  GA102 [GeForce RTX 3090 Ti]\n"
    "\t2330  GH100 [H100 SXM5 80GB]\n"
    "\t\t10de 1234  Some subsystem\n"
    "1ae0  Google, Inc.\n"
    "\t0063  Cloud TPU v5e\n"
    "C 03  Display controller\n"
    "\t00  VGA compatible controller\n"
)


@pytest.mark.parametrize("vendor,device", [
    ("10de", "2203"), ("10de", "ffff"), ("10de", "00"), ("1ae0", "0063"),
    ("1ae0", "9999"), ("8086", "10fb")])
def test_pciids_lookups_match_jax(vendor, device):
    db, jdb = pciids.PciIds.parse(PCI_DB), jpciids.PciIds.parse(PCI_DB)
    assert db.vendor_name(vendor) == jdb.vendor_name(vendor)
    assert db.device_name(vendor, device) == jdb.device_name(vendor, device)
    for d, jd in ((db, jdb), (None, None)):
        assert pciids.resource_suffix(vendor, device, d) == jpciids.resource_suffix(
            vendor, device, jd)
    assert pciids.sanitize_name(f" {vendor}--{device}!! ") == jpciids.sanitize_name(
        f" {vendor}--{device}!! ")


def test_builtin_nvidia_names_lead_the_database():
    db = pciids.PciIds.parse(PCI_DB)
    assert pciids.resource_suffix("10de", "2330", db) == "H100_SXM5_80GB"
    assert pciids.resource_suffix("10de", "2330") == "H100_SXM5_80GB"
    assert pciids.resource_suffix("10de", "2203", db) == "GA102_GEFORCE_RTX_3090_TI"
    shipped = pciids.PciIds.load(os.path.join(
        os.path.dirname(pciids.__file__), os.pardir, "data", "pci.ids"))
    assert shipped.vendor_name("10de") == "NVIDIA Corporation"
    for dev, name in pciids.BUILTIN_NVIDIA_DEVICES.items():
        assert shipped.device_name("10de", dev) is None
        assert pciids.resource_suffix("10de", dev, shipped) == name


def test_load_ladder_prefers_system_db_then_the_shipped_table(tmp_path, monkeypatch):
    system = tmp_path / "pci.ids"
    system.write_text("8086  Intel Corporation\n\t10fb  82599ES 10-Gigabit SFI/SFP+\n")
    monkeypatch.setattr(pciids, "SYSTEM_PCIIDS_PATHS", (str(system),))
    assert pciids.PciIds.load().vendor_name("8086") == "Intel Corporation"
    monkeypatch.setattr(pciids, "SYSTEM_PCIIDS_PATHS", (str(tmp_path / "missing"),))
    fallback = pciids.PciIds.load()
    assert fallback.device_name("8086", "10fb") is None
    assert fallback.vendor_name("10de") == "NVIDIA Corporation"
    with pytest.raises(OSError):
        pciids.PciIds.load(str(tmp_path / "nope.ids"))


def test_scan_gpus_mixed_host(fake):
    mixed_host(fake)
    inv = scan_gpus(fake.sysfs, fake.dev, fake.proc)
    assert [c.index for c in inv.chips] == [0, 1, 2]
    assert [c.pci_address for c in inv.chips] == [
        "0000:b8:00.0", "0000:19:00.0", "0000:3b:00.0"]  # by minor, not BDF order
    assert [c.numa_node for c in inv.chips] == [1, 0, 0]
    assert inv.chip(2).iommu_group == "20"
    assert inv.chip(0).dev_path == os.path.join(fake.dev, "nvidia0")
    assert all(c.pci_device == "2330" for c in inv.chips)
    assert inv.model_suffix == "H100_SXM5_80GB"
    assert inv.topology == HostTopology(gpu_count=3, numa_nodes=(1, 0, 0))
    # The vfio-bound GPU is the VFIO path's, with its audio function.
    vfio = scan_vfio(fake.sysfs, ("10de",))
    assert sorted(vfio.groups) == ["30"] and len(vfio.groups["30"]) == 2


def test_scan_gpus_missing_node_keeps_the_others(fake):
    for i in range(4):
        fake.add_nvidia_gpu(i, f"0000:{0x10 * (i + 1):02x}:00.0")
    fake.remove_dev_node("nvidia1")
    inv = scan_gpus(fake.sysfs, fake.dev, fake.proc)
    assert [c.index for c in inv.chips] == [0, 2, 3]
    assert inv.chip(2).pci_address == "0000:30:00.0"
    assert inv.chip(3).pci_address == "0000:40:00.0"


def test_scan_gpus_entry_without_a_minor(fake):
    """A procfs entry that names no minor vouches for no node: its GPU is
    left out, the others keep their functions."""
    fake.add_nvidia_gpu(0, "0000:19:00.0")
    fake.add_nvidia_gpu(1, "0000:3b:00.0", proc_minor=False)
    inv = scan_gpus(fake.sysfs, fake.dev, fake.proc)
    assert [(c.index, c.pci_address) for c in inv.chips] == [(0, "0000:19:00.0")]


def test_scan_gpus_leftover_node_and_strays_are_not_gpus(fake):
    fake.add_nvidia_gpu(0, "0000:19:00.0")
    fake.add_dev_node("nvidia5")  # the driver lists no GPU of minor 5
    for name in (*C.SHARED_NODES, "nvidia-modeset", "nvidia-caps"):
        fake.add_dev_node(name)
    assert [c.index for c in scan_gpus(fake.sysfs, fake.dev, fake.proc).chips] == [0]


def test_scan_gpus_empty_host(fake):
    inv = scan_gpus(fake.sysfs, fake.dev, fake.proc)
    assert inv.count == 0 and inv.model_suffix == "GPU"
    assert inv.topology == HostTopology(gpu_count=0)


def test_scan_gpus_with_procfs_hidden_keeps_answering_nodes(fake, monkeypatch):
    """No driver procfs and no PCI tree (a sandbox): each node the driver
    answers on is a GPU, without PCI identity; a node it refuses (EPERM:
    not this sandbox's card; ENXIO: no driver) or strays are not."""
    for n in ("nvidia0", "nvidia4", "nvidia6", "nvidia7", *C.SHARED_NODES):
        fake.add_dev_node(n)
    refused = {os.path.join(fake.dev, "nvidia0"): errno.EPERM,
               os.path.join(fake.dev, "nvidia6"): errno.ENXIO,
               os.path.join(fake.dev, "nvidia7"): errno.EBUSY}
    real_stat, real_open = os.stat, os.open

    class CharStat:
        st_mode = stat_mod.S_IFCHR | 0o666
        st_rdev = os.makedev(195, 0)

    def ours(p):
        return isinstance(p, str) and p.startswith(fake.dev)

    monkeypatch.setattr(gpu.os, "stat", lambda p, *a, **kw: CharStat()
                        if ours(p) else real_stat(p, *a, **kw))

    def _open(p, flags, *a):
        if p in refused:
            raise OSError(refused[p], os.strerror(refused[p]), p)
        if ours(p):
            return real_open(os.devnull, flags, *a)
        return real_open(p, flags, *a)

    monkeypatch.setattr(gpu.os, "open", _open)
    inv = scan_gpus(fake.sysfs, fake.dev, fake.proc)
    assert [c.index for c in inv.chips] == [4, 7]
    assert all(c.pci_address is None and c.major == 195 for c in inv.chips)
    assert inv.model_suffix == "GPU"


def test_driver_answers_classification(monkeypatch, tmp_path):
    f = tmp_path / "plain"
    f.write_text("")
    assert gpu.driver_answers(str(f)) and not gpu.driver_answers(str(tmp_path / "no"))

    class CharStat:
        st_mode = stat_mod.S_IFCHR | 0o600

    monkeypatch.setattr(gpu.os, "stat", lambda p: CharStat())
    for err, answers in ((errno.EBUSY, True), (errno.EPERM, False),
                         (errno.EACCES, False), (errno.ENXIO, False),
                         (errno.ENODEV, False)):
        def _open(path, flags, err=err):
            raise OSError(err, os.strerror(err), path)

        monkeypatch.setattr(gpu.os, "open", _open)
        assert gpu.driver_answers("/dev/nvidia0") is answers, errno.errorcode[err]


@pytest.mark.parametrize("raw,want", [
    ("00000000:19:00.0", "0000:19:00.0"), ("0000:19:00.0", "0000:19:00.0"),
    ("0000:B8:00.0", "0000:b8:00.0"), ("19:00.0", "0000:19:00.0"),
    (" 00000001:4C:00.1 ", "0001:4c:00.1")])
def test_normalize_bdf(raw, want):
    assert normalize_bdf(raw) == want


def test_normalize_bdf_rejects_garbage():
    for bad in ("", "N/A", "19-00.0"):
        with pytest.raises(ValueError):
            normalize_bdf(bad)


def test_upstream_path_and_runtime_env(fake):
    fake.add_nvidia_gpu(0, "0000:19:00.0", bridges=("pci0000:00", "0000:00:01.0",
                                                    "0000:01:00.0"))
    fake.add_nvidia_gpu(1, "0000:3b:00.0")
    inv = scan_gpus(fake.sysfs, fake.dev, fake.proc)
    assert inv.chip(0).upstream == ("pci0000:00", "0000:00:01.0", "0000:01:00.0")
    assert inv.chip(1).upstream == ()
    assert runtime_env(inv.topology) == {C.ENV_WORKER_ID: "0"}
    topo = HostTopology(gpu_count=2, worker_id=1, worker_hostnames=("a", "b"))
    assert runtime_env(topo) == {
        C.ENV_WORKER_ID: "1", C.ENV_WORKER_HOSTNAMES: "a,b"}
    assert topo.num_hosts == 2


def _chip(index, node, path=()):
    return gpu.GpuChip(index=index, dev_path=f"/dev/nvidia{index}",
                       numa_node=node, upstream=path)


def test_choose_chips_numa_then_switch():
    sw = {i: ("pci0000:00", f"0000:00:0{1 + i // 2}.0") for i in range(8)}
    chips = [_chip(i, i // 4, sw[i]) for i in range(8)]
    p = choose_chips(chips, [0, 2, 3, 4, 6], 2)
    assert p.chips == (2, 3) and p.contiguous
    assert choose_chips(chips, [0, 1, 4, 5, 6], 3).chips == (4, 5, 6)
    assert choose_chips(chips, [0, 1, 2, 4, 5], 2, must_include=[5]).chips == (4, 5)
    spill = choose_chips(chips, [1, 5, 6], 3)
    assert spill.chips == (1, 5, 6) and not spill.contiguous
    # No NUMA or PCI information: the lowest ids, still "one node".
    bare = [_chip(i, None) for i in range(4)]
    assert choose_chips(bare, [3, 1, 2], 2) == gpu_placement((1, 2), True)
    for bad in (dict(count=5), dict(count=1, must_include=[0, 1]),
                dict(count=1, must_include=[7])):
        with pytest.raises(ValueError):
            choose_chips(chips, [0, 1, 2, 3], **bad)


def gpu_placement(chips, contiguous):
    from kata_xpu_device_plugin_tpu_torch.topology import Placement

    return Placement(chips=chips, contiguous=contiguous)
