"""PyTorch port, the kubelet pod-resources client and ``status``'s pod
section against the JAX package's, on one response served by the JAX
tests' fake kubelet."""
from __future__ import annotations

import os
import shutil
import tempfile

import pytest

from kata_xpu_device_plugin_tpu.plugin.api import podresources_pb2 as jprpb
from kata_xpu_device_plugin_tpu.utils import podresources as jpod
from kata_xpu_device_plugin_tpu_torch.__main__ import pod_assignments, status_report
from kata_xpu_device_plugin_tpu_torch.config import Config
from kata_xpu_device_plugin_tpu_torch.discovery.sysfs import FakeSysfsBuilder
from kata_xpu_device_plugin_tpu_torch.utils import podresources as tpod

from .fake_kubelet import FakeKubelet


@pytest.fixture
def kubelet():
    d = tempfile.mkdtemp(prefix="kp-", dir="/tmp")  # unix socket paths are short
    fk = FakeKubelet(os.path.join(d, "kubelet")).start()
    fk.pod_resources = jprpb.ListPodResourcesResponse(pod_resources=[
        jprpb.PodResources(name="train-0", namespace="ml", containers=[
            jprpb.ContainerResources(name="main", devices=[
                jprpb.ContainerDevices(resource_name="nvidia.com/gpu",
                                       device_ids=["0", "3"]),
                jprpb.ContainerDevices(resource_name="example.com/nic",
                                       device_ids=["eth1"])]),
            jprpb.ContainerResources(name="sidecar")]),
        jprpb.PodResources(name="serve-1", namespace="default", containers=[
            jprpb.ContainerResources(name="guest", devices=[
                jprpb.ContainerDevices(resource_name="nvidia.com/vfio-10de-2330",
                                       device_ids=["42"])])]),
    ])
    yield fk
    fk.stop()
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("prefix", ["", "nvidia.com", "example.com", "google.com"])
def test_device_assignments_match_jax(kubelet, prefix):
    got = tpod.list_pod_resources(kubelet.socket_path, timeout_s=5.0)
    want = jpod.list_pod_resources(kubelet.socket_path, timeout_s=5.0)
    assert got.SerializeToString() == want.SerializeToString()
    assert tpod.device_assignments(got, prefix) == jpod.device_assignments(want, prefix)


def test_status_pod_section(kubelet, tmp_path):
    """``status --json``'s pod section lists this namespace's devices from
    the kubelet's socket, as JAX's ``device_assignments`` gives them; a
    socket that does not answer leaves ``pod_assignments_error`` alone."""
    fake = FakeSysfsBuilder(root=str(tmp_path / "host"))
    fake.add_nvidia_gpu(0, "0000:18:00.0")
    cfg = Config(sysfs_root=fake.sysfs, dev_root=fake.dev, proc_root=fake.proc,
                 cdi_dir=str(tmp_path / "cdi"), state_dir="", metrics_port=0,
                 pod_resources_socket=kubelet.socket_path)
    want = jpod.device_assignments(kubelet.pod_resources, "nvidia.com")
    assert [a["pod"] for a in want] == ["train-0", "serve-1"]
    rep = status_report(cfg)
    assert rep["pod_assignments"] == want and "pod_assignments_error" not in rep
    assert pod_assignments(cfg) == want
    cfg.pod_resources_socket = str(tmp_path / "missing.sock")
    rep = status_report(cfg)
    assert "pod_assignments" not in rep and rep["pod_assignments_error"]
