"""PyTorch port, host daemon: the CDI model and writer. Each case of
``tests/test_cdi.py`` runs through the port's ``cdi`` (the golden YAML, both
formats' round trips, the atomic write, per-kind file names, qualified
names, validation, pruning, removal); a GPU spec the port's manager builds
is loaded by the JAX package's ``cdi.load`` and rendered back equal, and a
TPU spec of JAX's by the port's; qualified names and kinds are judged the
same by both packages over drawn strings."""
from __future__ import annotations

import os

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from kata_xpu_device_plugin_tpu import cdi as jcdi
from kata_xpu_device_plugin_tpu.config import Config as JaxConfig
from kata_xpu_device_plugin_tpu.discovery import scan_tpus
from kata_xpu_device_plugin_tpu.plugin.manager import build_tpu_spec
from kata_xpu_device_plugin_tpu_torch import cdi
from kata_xpu_device_plugin_tpu_torch.cdi import constants as C
from kata_xpu_device_plugin_tpu_torch.config import Config
from kata_xpu_device_plugin_tpu_torch.discovery import FakeSysfsBuilder, scan_gpus
from kata_xpu_device_plugin_tpu_torch.plugin.manager import build_gpu_spec

from . import test_cdi as jax_cases


def _tpu_spec(pkg) -> object:
    """``tests/test_cdi.py``'s spec, built with ``pkg``'s classes."""
    spec = pkg.Spec(kind="google.com/tpu", cdi_version="0.6.0")
    spec.container_edits.add_env("TPU_SKIP_MDS_QUERY", "true")
    spec.container_edits.mounts.append(
        pkg.Mount(host_path="/usr/lib/tpu/libtpu.so",
                  container_path="/usr/lib/tpu/libtpu.so"))
    for i in range(2):
        spec.add_device(pkg.Device(
            name=str(i),
            annotations={C.ANNOTATION_BDF: f"0000:0{i}:00.0"},
            container_edits=pkg.ContainerEdits(
                device_nodes=[pkg.DeviceNode(path=f"/dev/accel{i}", type="c",
                                             permissions="rw")],
                env=[f"TPU_VISIBLE_CHIPS={i}"],
            ),
        ))
    return spec


def test_golden_yaml_shape():
    assert cdi.render(_tpu_spec(cdi), cdi.FORMAT_YAML) == jax_cases.GOLDEN_YAML


@pytest.mark.parametrize("fmt", [cdi.FORMAT_YAML, cdi.FORMAT_JSON])
def test_roundtrip_and_file_name(tmp_path, fmt):
    spec = _tpu_spec(cdi)
    path = cdi.save(spec, str(tmp_path), fmt)
    assert os.path.basename(path) == f"google.com-tpu.{'json' if fmt == 'json' else 'yaml'}"
    assert cdi.load(path).to_dict() == spec.to_dict()
    assert oct(os.stat(path).st_mode & 0o777) == "0o644"


def test_atomic_write_leaves_no_tmp(tmp_path):
    cdi.save(_tpu_spec(cdi), str(tmp_path))
    assert [f for f in os.listdir(tmp_path) if f.startswith(".cdi-")] == []


def test_per_kind_filenames_do_not_collide(tmp_path):
    cdi.save(cdi.Spec(kind="nvidia.com/gpu"), str(tmp_path))
    cdi.save(cdi.Spec(kind="nvidia.com/vfio"), str(tmp_path), cdi.FORMAT_JSON)
    assert sorted(os.listdir(tmp_path)) == ["nvidia.com-gpu.yaml", "nvidia.com-vfio.json"]


def test_qualified_names():
    qn = cdi.qualified_name("nvidia.com", "gpu", "3")
    assert qn == "nvidia.com/gpu=3"
    assert cdi.parse_qualified_name(qn) == ("nvidia.com", "gpu", "3")
    assert cdi.is_qualified_name("nvidia.com/gpu=0")
    assert not cdi.is_qualified_name("nvidia.com/gpu")
    assert not cdi.is_qualified_name("no-slash=0")
    with pytest.raises(ValueError):
        cdi.qualified_name("nvidia.com", "gpu", "bad name")


def test_invalid_kind_and_duplicate_device():
    with pytest.raises(ValueError):
        cdi.Spec(kind="noslash")
    spec = cdi.Spec(kind="nvidia.com/gpu")
    spec.add_device(cdi.Device(name="0"))
    with pytest.raises(ValueError):
        spec.add_device(cdi.Device(name="0"))
    with pytest.raises(ValueError):
        cdi.Device(name="-bad")


def test_empty_fields_pruned():
    spec = cdi.Spec(kind="nvidia.com/gpu")
    d = spec.to_dict()
    assert "devices" not in d and "annotations" not in d and "containerEdits" not in d
    assert yaml.safe_load(cdi.render(spec)) == {"cdiVersion": "0.6.0",
                                                "kind": "nvidia.com/gpu"}
    with pytest.raises(ValueError):
        cdi.render(spec, "toml")


def test_remove(tmp_path):
    spec = _tpu_spec(cdi)
    for fmt in (cdi.FORMAT_YAML, cdi.FORMAT_JSON):
        cdi.save(spec, str(tmp_path), fmt)
    cdi.remove(str(tmp_path), spec.kind)
    cdi.remove(str(tmp_path), spec.kind)  # a second removal finds nothing
    assert os.listdir(tmp_path) == []


def _gpu_spec(tmp_path):
    fake = FakeSysfsBuilder(root=str(tmp_path / "host"))
    for i in range(4):
        fake.add_nvidia_gpu(i, f"0000:{0x19 + i:02x}:00.0", numa_node=i // 2)
    for name in C.SHARED_NODES[:2]:  # no nvidia-uvm-tools on this host
        fake.add_dev_node(name)
    cfg = Config(sysfs_root=fake.sysfs, dev_root=fake.dev, proc_root=fake.proc)
    return build_gpu_spec(scan_gpus(fake.sysfs, fake.dev, fake.proc), cfg), fake


@pytest.mark.parametrize("fmt", [cdi.FORMAT_YAML, cdi.FORMAT_JSON])
def test_port_gpu_spec_loads_in_jax_and_renders_back_equal(tmp_path, fmt):
    spec, fake = _gpu_spec(tmp_path)
    path = cdi.save(spec, str(tmp_path / "cdi"), fmt)
    back = jcdi.load(path)
    assert jcdi.render(back, fmt) == cdi.render(spec, fmt)
    with open(path) as f:
        assert f.read() == jcdi.render(back, fmt)
    assert back.device_names() == ["0", "1", "2", "3"]
    assert [n.path for n in back.container_edits.device_nodes] == [
        "/dev/nvidiactl", "/dev/nvidia-uvm"]
    node = back.devices[2].container_edits.device_nodes[0]
    assert (node.path, node.host_path, node.type, node.permissions) == (
        "/dev/nvidia2", os.path.join(fake.dev, "nvidia2"), "c", "rw")
    assert back.devices[2].annotations == {"bdf": "0000:1b:00.0"}


@pytest.mark.parametrize("fmt", [cdi.FORMAT_YAML, cdi.FORMAT_JSON])
def test_jax_tpu_spec_loads_in_the_port_and_renders_back_equal(tmp_path, fmt):
    fake = FakeSysfsBuilder(root=str(tmp_path / "host"))
    for i in range(4):
        fake.add_accel_chip(i)
        fake.add_pci_function(f"0000:0{i}:01.0", "1ae0", "0063", numa_node=i // 2)
    libtpu = tmp_path / "libtpu.so"
    libtpu.write_text("")
    jcfg = JaxConfig(sysfs_root=fake.sysfs, dev_root=fake.dev,
                     libtpu_host_path=str(libtpu))
    jspec = build_tpu_spec(scan_tpus(fake.sysfs, fake.dev, env={}), jcfg)
    path = jcdi.save(jspec, str(tmp_path / "cdi"), fmt)
    back = cdi.load(path)
    assert cdi.render(back, fmt) == jcdi.render(jspec, fmt)
    assert back.container_edits.mounts[0].host_path == str(libtpu)


NAME_CHARS = st.text(alphabet="ab0Z._-:/= \t", max_size=12)


@settings(max_examples=300, deadline=None, database=None)
@given(vendor=NAME_CHARS, cls=NAME_CHARS, device=NAME_CHARS)
def test_names_are_judged_as_jax_judges_them(vendor, cls, device):
    name = f"{vendor}/{cls}={device}"
    assert cdi.is_qualified_name(name) == jcdi.is_qualified_name(name)
    for fn, jfn, args in ((cdi.qualified_name, jcdi.qualified_name, (vendor, cls, device)),
                          (cdi.parse_qualified_name, jcdi.parse_qualified_name, (name,)),
                          (cdi.parse_kind, jcdi.parse_kind, (f"{vendor}/{cls}",))):
        try:
            want = jfn(*args)
        except ValueError:
            with pytest.raises(ValueError):
                fn(*args)
        else:
            assert fn(*args) == want
