"""The GPU daemon's DaemonSet (``deploy/kata-gpu-device-plugin.yaml``), its
image (``Dockerfile.gpu``) and console script, checked statically as
``tests/test_deploy.py`` checks the TPU daemon's: no cluster, no build."""
from __future__ import annotations

import argparse
import re
import tomllib
from pathlib import Path

import pytest
import yaml

from kata_xpu_device_plugin_tpu_torch import config

REPO = Path(__file__).resolve().parent.parent
MANIFEST = REPO / "deploy" / "kata-gpu-device-plugin.yaml"


@pytest.fixture(scope="module")
def spec():
    doc = yaml.safe_load(MANIFEST.read_text())
    assert doc["kind"] == "DaemonSet" and doc["apiVersion"] == "apps/v1"
    return doc["spec"]["template"]["spec"]


def _container(spec):
    (container,) = spec["containers"]
    return container


def test_schedules_on_gpu_nodes_by_an_exists_match(spec):
    terms = spec["affinity"]["nodeAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"]["nodeSelectorTerms"]
    exprs = [e for t in terms for e in t["matchExpressions"]]
    assert exprs == [{"key": "nvidia.com/gpu.present", "operator": "Exists"}]
    assert any(t.get("key") == "nvidia.com/gpu" and t.get("operator") == "Exists"
               for t in spec["tolerations"])


def test_runs_the_port_daemon_with_flags_it_takes(spec):
    c = _container(spec)
    assert c["command"] == ["python", "-m", "kata_xpu_device_plugin_tpu_torch"]
    assert c["args"][0] == "run"
    parser = argparse.ArgumentParser()
    config.add_flags(parser)
    cfg = config.from_args(parser.parse_args(c["args"][1:]))
    mounts = {m["mountPath"]: m for m in c["volumeMounts"]}
    assert cfg.proc_root in mounts and mounts[cfg.proc_root]["readOnly"] is True
    assert cfg.guest_events_dir.startswith(cfg.state_dir + "/")


def test_mounts_are_backed_by_the_host_paths_the_daemon_reads(spec):
    volumes = {v["name"]: v for v in spec["volumes"]}
    c = _container(spec)
    by_path = {}
    for m in c["volumeMounts"]:
        assert m["name"] in volumes, f"mount {m['name']} has no volume"
        by_path[m["mountPath"]] = volumes[m["name"]]["hostPath"]["path"]
    defaults = config.Config()
    for mount, host in (
            (defaults.kubelet_socket_dir, "/var/lib/kubelet/device-plugins"),
            ("/var/lib/kubelet/pod-resources", "/var/lib/kubelet/pod-resources"),
            (defaults.dev_root, "/dev"), (defaults.sysfs_root, "/sys"),
            ("/host/proc", "/proc"), (defaults.cdi_dir, "/var/run/cdi"),
            (defaults.state_dir, "/var/run/kata-tpu")):
        assert by_path.get(mount) == host, mount
    assert Path(defaults.pod_resources_socket).parent.as_posix() in by_path
    read_only = {m["mountPath"] for m in c["volumeMounts"] if m.get("readOnly")}
    assert read_only == {"/sys", "/host/proc"}


def test_node_name_from_the_downward_api(spec):
    env = {e["name"]: e for e in _container(spec)["env"]}
    assert env["KATA_TPU_NODE_NAME"]["valueFrom"]["fieldRef"]["fieldPath"] == (
        "spec.nodeName")
    assert hasattr(config.Config(), "node_name")


def test_image_and_console_script(spec):
    tag = _container(spec)["image"].rsplit(":", 1)[1]
    version = re.search(r"^VERSION\s*:=\s*(\S+)", (REPO / "Makefile").read_text(),
                        re.M).group(1)
    assert tag == f"v{version}"
    docker = (REPO / "Dockerfile.gpu").read_text()
    assert "COPY kata_xpu_device_plugin_tpu_torch ./kata_xpu_device_plugin_tpu_torch" in docker
    assert "COPY kata_xpu_device_plugin_tpu " not in docker
    assert "whl/cpu" in docker and 'ENTRYPOINT ["kata-gpu-device-plugin"]' in docker
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["kata-gpu-device-plugin"] == "kata_xpu_device_plugin_tpu_torch.__main__:main"
    assert scripts["kata-tpu-device-plugin"] == "kata_xpu_device_plugin_tpu.__main__:main"
