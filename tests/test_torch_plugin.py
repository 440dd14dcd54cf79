"""PyTorch port, host daemon: the GPU device plugin against the JAX tests'
fake kubelet and a fake sysfs/dev/proc host, a GPU mirror of each TPU-path
case of ``tests/test_plugin.py`` (registration, ListAndWatch, health flips,
the three strategies, re-validation, unknown or unhealthy ids, kubelet
restart, rescan, the zero-GPU dry run, the journal's reconcile). Every
serving knob's env is held to the key and value JAX's ``TpuAllocator``
gives; the VFIO path's Allocate and preferred answers are held byte for
byte to JAX's on the same tree and config. The daemon's scan and allocate
run in a subprocess that must never initialize CUDA."""
from __future__ import annotations

import errno
import json
import os
import shutil
import signal
import stat as stat_mod
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import grpc
import pytest

from kata_xpu_device_plugin_tpu.config import Config as JaxConfig
from kata_xpu_device_plugin_tpu.discovery import scan_tpus
from kata_xpu_device_plugin_tpu.plugin import PluginManager as JaxManager
from kata_xpu_device_plugin_tpu.plugin import TpuAllocator
from kata_xpu_device_plugin_tpu_torch import cdi, obs
from kata_xpu_device_plugin_tpu_torch.cdi import constants as C
from kata_xpu_device_plugin_tpu_torch.config import Config
from kata_xpu_device_plugin_tpu_torch.discovery import scan_gpus
from kata_xpu_device_plugin_tpu_torch.discovery.sysfs import FakeSysfsBuilder
from kata_xpu_device_plugin_tpu_torch.discovery.vfio import VfioDevice, VfioInventory
from kata_xpu_device_plugin_tpu_torch.obs import metrics as obs_metrics
from kata_xpu_device_plugin_tpu_torch.plugin import (
    AllocationJournal,
    DevicePluginServer,
    DeviceState,
    GpuAllocator,
    HealthWatcher,
    PluginManager,
    VfioAllocator,
)
from kata_xpu_device_plugin_tpu_torch.plugin import health as H
from kata_xpu_device_plugin_tpu_torch.plugin.api import deviceplugin_pb2 as pb
from kata_xpu_device_plugin_tpu_torch.plugin.api import glue
from kata_xpu_device_plugin_tpu_torch.plugin.manager import gpu_watched_devices

from .fake_kubelet import FakeKubelet

REPO = Path(__file__).resolve().parent.parent
RESOURCE = "nvidia.com/gpu"


@pytest.fixture
def short_dir():
    # unix socket paths are capped (~108 chars); pytest tmp_path is too deep.
    d = tempfile.mkdtemp(prefix="kg-", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def kubelet(short_dir):
    fk = FakeKubelet(os.path.join(short_dir, "kubelet")).start()
    yield fk
    fk.stop()


def bdf(i: int) -> str:
    return f"0000:{0x18 + 0x10 * i:02x}:00.0"


def hgx_host(fake: FakeSysfsBuilder, n: int = 8) -> FakeSysfsBuilder:
    """An HGX-style host: ``n`` H100s, half a NUMA node each, two GPUs
    behind each PCI switch, the driver's shared nodes."""
    for i in range(n):
        fake.add_nvidia_gpu(
            i, bdf(i), numa_node=i // 4, iommu_group=str(20 + i),
            bridges=("pci0000:00", f"0000:00:0{1 + i // 2}.0"))
    for name in C.SHARED_NODES:
        fake.add_dev_node(name)
    return fake


@pytest.fixture
def hgx(short_dir):
    return hgx_host(FakeSysfsBuilder(root=os.path.join(short_dir, "host")))


def make_config(fake, kubelet, short_dir, **overrides) -> Config:
    kw = dict(
        sysfs_root=fake.sysfs,
        dev_root=fake.dev,
        proc_root=fake.proc,
        cdi_dir=os.path.join(short_dir, "cdi"),
        kubelet_socket_dir=kubelet.socket_dir,
        state_dir="",
        rescan_interval_s=0,  # tests drive rescans explicitly
        health_poll_interval_s=3600,  # tests drive evaluate() explicitly
        metrics_port=0,
    )
    kw.update(overrides)
    return Config(**kw)


@pytest.fixture
def manager(hgx, kubelet, short_dir):
    mgr = PluginManager(make_config(hgx, kubelet, short_dir))
    mgr.start()
    yield mgr
    mgr.stop()


def _allocate(stub, *groups):
    return stub.Allocate(pb.AllocateRequest(container_requests=[
        pb.ContainerAllocateRequest(device_ids=list(g)) for g in groups]))


def test_registration_and_options(manager, kubelet):
    assert kubelet.registered.wait(5)
    (reg,) = kubelet.registrations
    assert reg.resource_name == RESOURCE
    assert reg.version == "v1beta1"
    assert reg.options.get_preferred_allocation_available
    ch, stub = kubelet.plugin_stub(reg.endpoint)
    with ch:
        assert stub.GetDevicePluginOptions(pb.Empty()).get_preferred_allocation_available


def test_list_and_watch_initial(manager, kubelet):
    ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
    with ch:
        stream = stub.ListAndWatch(pb.Empty())
        first = next(stream)
        assert [d.id for d in first.devices] == [str(i) for i in range(8)]
        assert all(d.health == glue.HEALTHY for d in first.devices)
        assert first.devices[5].topology.nodes[0].id == 1  # NUMA propagated
        stream.cancel()


def test_health_transition_streams_update(manager, kubelet, hgx):
    plugin = manager.plugins()[0]
    watcher = HealthWatcher([plugin], use_inotify=False)
    ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
    with ch:
        stream = stub.ListAndWatch(pb.Empty())
        next(stream)
        hgx.remove_dev_node("nvidia3")
        watcher.evaluate()
        sick = {d.id: d.health for d in next(stream).devices}
        assert sick["3"] == glue.UNHEALTHY and sick["2"] == glue.HEALTHY
        hgx.add_dev_node("nvidia3")
        watcher.evaluate()
        assert {d.id: d.health for d in next(stream).devices}["3"] == glue.HEALTHY
        stream.cancel()


def test_allocate_cdi_cri(manager, kubelet):
    ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
    with ch:
        (cresp,) = _allocate(stub, ["0", "1", "2", "3"]).container_responses
    assert [d.name for d in cresp.cdi_devices] == [f"{RESOURCE}={i}" for i in range(4)]
    assert cresp.envs[C.ENV_CDI_VENDOR_CLASS] == RESOURCE
    assert cresp.envs[C.ENV_TPU_VISIBLE_CHIPS] == "0,1,2,3"
    assert len(cresp.envs[C.ENV_TRACE_CTX]) == 16
    assert not cresp.devices and not cresp.annotations  # cdi-cri only


def test_cdi_annotations_strategy(hgx, kubelet, short_dir):
    mgr = PluginManager(make_config(hgx, kubelet, short_dir,
                                    strategies=("cdi-annotations",)))
    mgr.start()
    try:
        ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
        with ch:
            (cr,) = _allocate(stub, ["4", "5"]).container_responses
        assert dict(cr.annotations) == {
            "cdi.k8s.io/nvidia.com_gpu": f"{RESOURCE}=4,{RESOURCE}=5"}
        assert not cr.cdi_devices and not cr.devices
    finally:
        mgr.stop()


# Each serving knob: its Config field, a value, and the env JAX's
# TpuAllocator injects for the same value.
KNOBS = {
    "prefix_cache_tokens": 4096,
    "kv_pool_tokens": 8000,
    "kv_quant": "bf16",
    "kv_layout": "blocks",
    "kv_host_tokens": 2048,
    "checkpoint_rounds": 4,
    "faults": "decode_dispatch:16,fence:7:hang",
    "sched_policy": "slo_chunked",
    "prefill_chunk": 128,
    "itl_slo_ms": 25.0,
    "decode_steps": 8,
    "serving_tp": 2,
    "serving_tp_min": 1,
    "heartbeat_rounds": 16,
}
# Config field -> allocator argument, where the names differ.
ALLOC_ARG = {"faults": "fault_schedule"}


def _jax_inventory(short_dir):
    fake = FakeSysfsBuilder(root=os.path.join(short_dir, "tpu"))
    for i in range(4):
        fake.add_accel_chip(i)
    return scan_tpus(fake.sysfs, fake.dev, env={})


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_env_matches_jax(hgx, short_dir, knob):
    """A knob set rides the env under JAX's key with JAX's value; unset (or
    at its no-op value) it injects nothing, as in JAX."""
    inv = scan_gpus(hgx.sysfs, hgx.dev, hgx.proc)
    jinv = _jax_inventory(short_dir)
    arg = ALLOC_ARG.get(knob, knob)
    kw = {arg: KNOBS[knob]}
    got = GpuAllocator(lambda: inv, "nvidia.com", "gpu", **kw).allocate(["0", "1"])
    want = TpuAllocator(lambda: jinv, "google.com", "tpu", **kw).allocate(["0", "1"])
    knob_keys = {k for k in want.envs if k.startswith("KATA_TPU_")} - {
        "KATA_TPU_TRACE_CTX"}
    assert knob_keys
    assert {k: got.envs[k] for k in knob_keys} == {k: want.envs[k] for k in knob_keys}
    bare = GpuAllocator(lambda: inv, "nvidia.com", "gpu").allocate(["0"])
    jbare = TpuAllocator(lambda: jinv, "google.com", "tpu").allocate(["0"])
    assert not knob_keys & set(bare.envs) and not knob_keys & set(jbare.envs)
    if knob == "decode_steps":  # K = 1 is the guest default: nothing injected
        one = GpuAllocator(lambda: inv, "nvidia.com", "gpu", decode_steps=1)
        assert C.ENV_DECODE_STEPS not in one.allocate(["0"]).envs


def test_guest_events_and_trace_envs_match_jax(hgx, short_dir):
    inv = scan_gpus(hgx.sysfs, hgx.dev, hgx.proc)
    jinv = _jax_inventory(short_dir)
    kw = dict(guest_events_dir="/run/kata/guest-events", heartbeat_rounds=16)
    got = GpuAllocator(lambda: inv, "nvidia.com", "gpu", **kw).allocate(["0", "1"])
    want = TpuAllocator(lambda: jinv, "google.com", "tpu", **kw).allocate(["0", "1"])
    for key in (C.ENV_OBS, C.ENV_OBS_FILE, C.ENV_HEARTBEAT_ROUNDS):
        assert got.envs[key] == want.envs[key]
    assert got.envs[C.ENV_OBS_FILE] == "/run/kata/guest-events/guest_0-1.jsonl"
    with obs.span("plugin.Allocate") as sp:
        inside = GpuAllocator(lambda: inv, "nvidia.com", "gpu").allocate(["0"])
    assert inside.envs[C.ENV_TRACE_CTX] == sp.trace_id
    off = GpuAllocator(lambda: inv, "nvidia.com", "gpu", trace_context=False)
    assert C.ENV_TRACE_CTX not in off.allocate(["0"]).envs


def test_allocate_telemetry_span_and_latency(manager, kubelet, tmp_path):
    """An Allocate call emits one span event (trace id, every container's
    device ids) and a sample into the gRPC latency histogram; a
    ListAndWatch update records under its own method label."""
    sink = obs.EventSink(str(tmp_path / "plugin.jsonl"))
    prev = obs.set_default_sink(sink)
    try:
        ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
        with ch:
            stream = stub.ListAndWatch(pb.Empty())
            next(stream)
            _allocate(stub, ["0", "1"], ["2", "3"])
            stream.cancel()
    finally:
        sink.close()
        obs.set_default_sink(prev)
    evs = obs.read_events(str(tmp_path / "plugin.jsonl"))
    (alloc,) = [e for e in evs if e["name"] == "plugin.Allocate"]
    assert alloc["devices"] == "0,1,2,3"
    assert alloc["containers"] == 2
    assert alloc["resource"] == RESOURCE
    assert alloc["trace"] and alloc["span"] and alloc["dur_s"] > 0
    updates = [e for e in evs if e["name"] == "plugin.ListAndWatch_update"]
    assert updates and all(u["devices"] == 8 for u in updates)
    text = obs_metrics.DEFAULT_REGISTRY.exposition()
    assert ('kata_tpu_device_plugin_grpc_handler_seconds_count'
            f'{{method="Allocate",resource="{RESOURCE}"}}') in text
    assert 'method="ListAndWatch_update"' in text


def test_allocate_unknown_and_unhealthy(manager, kubelet, hgx):
    ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
    with ch:
        with pytest.raises(grpc.RpcError) as exc:
            _allocate(stub, ["42"])
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        hgx.remove_dev_node("nvidia1")
        HealthWatcher([manager.plugins()[0]], use_inotify=False).evaluate()
        with pytest.raises(grpc.RpcError) as exc:
            _allocate(stub, ["1"])
        assert exc.value.code() == grpc.StatusCode.UNAVAILABLE


def test_allocate_revalidates_dev_node(kubelet, hgx):
    # The node vanishes between a health pass and Allocate: fail closed. A
    # standalone server (no health watcher) isolates the re-validation.
    inv = scan_gpus(hgx.sysfs, hgx.dev, hgx.proc)
    server = DevicePluginServer(
        resource_name=RESOURCE,
        state=DeviceState(gpu_watched_devices(inv, hgx.sysfs)),
        allocator=GpuAllocator(lambda: inv, "nvidia.com", "gpu"),
        socket_dir=kubelet.socket_dir,
    )
    server.start(register=False)
    try:
        ch, stub = kubelet.plugin_stub(server.endpoint)
        with ch:
            hgx.remove_dev_node("nvidia2")  # no watcher ran: still Healthy
            with pytest.raises(grpc.RpcError) as exc:
                _allocate(stub, ["2"])
            assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        server.stop()


def test_preferred_allocation_keeps_numa_and_switch(manager, kubelet):
    """GPUs 0-3 are NUMA node 0 and 4-7 node 1, two a PCI switch: a
    request of 2 goes to a free switch pair, one of 3 stays on one node, and
    must-include pins the node."""
    ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)

    def preferred(avail, size, must=()):
        resp = stub.GetPreferredAllocation(pb.PreferredAllocationRequest(
            container_requests=[pb.ContainerPreferredAllocationRequest(
                available_device_ids=avail, must_include_device_ids=list(must),
                allocation_size=size)]))
        return list(resp.container_responses[0].device_ids)

    with ch:
        assert preferred(["0", "2", "3", "4", "6"], 2) == ["2", "3"]
        assert preferred(["0", "1", "4", "5", "6"], 3) == ["4", "5", "6"]
        assert preferred(["0", "1", "2", "4", "5", "6", "7"], 2, must=["2"]) == ["0", "2"]
        assert preferred(["1", "5", "6"], 3) == ["1", "5", "6"]


def test_kubelet_restart_reregisters(manager, kubelet):
    assert kubelet.registered.wait(5)
    plugin = manager.plugins()[0]
    os.unlink(plugin.socket_path)  # the kubelet wiped its dir
    HealthWatcher([plugin], use_inotify=False).evaluate()
    deadline = time.time() + 5
    while len(kubelet.registrations) < 2 and time.time() < deadline:
        time.sleep(0.05)
    assert len(kubelet.registrations) >= 2 and plugin.serving
    ch, stub = kubelet.plugin_stub(kubelet.registrations[-1].endpoint)
    with ch:
        assert stub.GetDevicePluginOptions(pb.Empty()).get_preferred_allocation_available


def test_cdi_spec_written(manager, hgx):
    spec = cdi.load(os.path.join(manager.cfg.cdi_dir, "nvidia.com-gpu.yaml"))
    assert spec.device_names() == [str(i) for i in range(8)]
    assert spec.container_edits.env == ["TPU_WORKER_ID=0"]
    shared = [n.path for n in spec.container_edits.device_nodes]
    assert shared == ["/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools"]
    node = spec.devices[3].container_edits.device_nodes[0]
    assert node.path == "/dev/nvidia3"  # in-guest path, not the fake root
    assert node.host_path == os.path.join(hgx.dev, "nvidia3")
    assert spec.devices[3].annotations == {C.ANNOTATION_BDF: bdf(3)}


def test_rescan_picks_up_new_gpu(kubelet, short_dir):
    fake = FakeSysfsBuilder(root=os.path.join(short_dir, "host"))
    fake.add_nvidia_gpu(0, bdf(0))
    mgr = PluginManager(make_config(fake, kubelet, short_dir))
    mgr.start()
    try:
        assert mgr.plugins()[0].state.ids() == ["0"]
        fake.add_nvidia_gpu(1, bdf(1))
        assert mgr.rescan_once() is True
        assert mgr.plugins()[0].state.ids() == ["0", "1"]
        assert mgr.rescan_once() is False  # idempotent
        fake.unbind_driver(bdf(0))  # the driver no longer lists GPU 0
        assert mgr.rescan_once() is True
        assert mgr.plugins()[0].state.ids() == ["1"]
        spec = cdi.load(os.path.join(mgr.cfg.cdi_dir, "nvidia.com-gpu.yaml"))
        assert spec.device_names() == ["1"]
    finally:
        mgr.stop()


def test_zero_gpu_dry_run(kubelet, short_dir):
    fake = FakeSysfsBuilder(root=os.path.join(short_dir, "host"))
    mgr = PluginManager(make_config(fake, kubelet, short_dir))
    mgr.start()
    try:
        assert kubelet.registered.wait(5)
        ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
        with ch:
            stream = stub.ListAndWatch(pb.Empty())
            assert len(next(stream).devices) == 0
            stream.cancel()
        assert not os.path.exists(os.path.join(mgr.cfg.cdi_dir, "nvidia.com-gpu.yaml"))
    finally:
        mgr.stop()


def _vfio_tree(root):
    fake = FakeSysfsBuilder(root=root)
    fake.add_pci_function("0000:01:00.0", "10de", "2330", driver="vfio-pci",
                          iommu_group="11", numa_node=0)
    fake.add_pci_function("0000:02:00.0", "10de", "2330", driver="vfio-pci",
                          iommu_group="12", numa_node=1)
    fake.add_pci_function("0000:03:00.0", "10de", "2330", driver="vfio-pci",
                          iommu_group="13", numa_node=1)
    return fake


def test_vfio_plugin_answers_byte_equal_to_jax(short_dir):
    """The same tree, namespace and strategies: both daemons' VFIO plugins
    answer Allocate (two containers), GetPreferredAllocation and an unknown
    group with the same bytes and status; the two specs render the same."""
    fake = _vfio_tree(os.path.join(short_dir, "host"))
    answers, specs, names = {}, {}, {}
    for side in ("jax", "torch"):
        fk = FakeKubelet(os.path.join(short_dir, f"k-{side}")).start()
        common = dict(sysfs_root=fake.sysfs, dev_root=fake.dev, state_dir="",
                      cdi_dir=os.path.join(short_dir, f"cdi-{side}"),
                      kubelet_socket_dir=fk.socket_dir, rescan_interval_s=0,
                      health_poll_interval_s=3600, metrics_port=0,
                      resource_namespace="nvidia.com", vfio_vendors=("10de",))
        mgr = (JaxManager(JaxConfig(libtpu_host_path="", **common)) if side == "jax"
               else PluginManager(Config(proc_root=fake.proc, **common)))
        mgr.start()
        try:
            (reg,) = [r for r in fk.registrations
                      if r.resource_name.split("/")[1] not in ("tpu", "gpu")]
            ch, stub = fk.plugin_stub(reg.endpoint)
            with ch:
                alloc = _allocate(stub, ["11"], ["12", "13"])
                pref = stub.GetPreferredAllocation(pb.PreferredAllocationRequest(
                    container_requests=[pb.ContainerPreferredAllocationRequest(
                        available_device_ids=["11", "12", "13"],
                        allocation_size=2)]))
                with pytest.raises(grpc.RpcError) as exc:
                    _allocate(stub, ["99"])
            names[side] = reg.resource_name
            answers[side] = (alloc.SerializeToString(deterministic=True),
                             pref.SerializeToString(deterministic=True),
                             exc.value.code())
            with open(os.path.join(mgr.cfg.cdi_dir, "nvidia.com-vfio.yaml")) as f:
                specs[side] = f.read()
        finally:
            mgr.stop()
            fk.stop()
    assert answers["torch"] == answers["jax"]
    assert specs["torch"] == specs["jax"]
    # The resource names differ by design: the port names the model from
    # its built-in NVIDIA table, JAX's bundled table has no NVIDIA ids.
    assert names == {"torch": "nvidia.com/H100_SXM5_80GB", "jax": "nvidia.com/2330"}


def test_vfio_allocate_fails_after_unbind(kubelet, short_dir):
    fake = _vfio_tree(os.path.join(short_dir, "host"))
    mgr = PluginManager(make_config(fake, kubelet, short_dir, vfio_vendors=("10de",)))
    mgr.start()
    try:
        reg = next(r for r in kubelet.registrations if r.resource_name != RESOURCE)
        # Rebound from vfio-pci to nvidia between discovery and Allocate.
        fake.add_pci_function("0000:01:00.0", "10de", "2330", driver="nvidia",
                              iommu_group="11")
        ch, stub = kubelet.plugin_stub(reg.endpoint)
        with ch:
            with pytest.raises(grpc.RpcError) as exc:
                _allocate(stub, ["11"])
            assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        mgr.stop()


def test_vfio_preferred_numa_affinity_matches_jax():
    from kata_xpu_device_plugin_tpu.discovery.vfio import VfioDevice as JDev
    from kata_xpu_device_plugin_tpu.discovery.vfio import VfioInventory as JInv
    from kata_xpu_device_plugin_tpu.plugin.allocators import VfioAllocator as JAlloc

    inv, jinv = VfioInventory(), JInv()
    for group, node in [("1", 0), ("2", 1), ("3", 0), ("4", 1), ("5", 1)]:
        kw = dict(address=f"0000:0{group}:00.0", vendor="10de", device="2330",
                  iommu_group=group, numa_node=node)
        inv.groups[group] = [VfioDevice(**kw)]
        jinv.groups[group] = [JDev(**kw)]
    alloc = VfioAllocator(lambda: inv, "nvidia.com", ("10de", "2330"))
    jalloc = JAlloc(lambda: jinv, "nvidia.com", ("10de", "2330"))
    avail = ["1", "2", "3", "4", "5"]
    for must, size in (([], 3), (["1"], 2), ([], 4), (["2", "3"], 3)):
        assert alloc.preferred(avail, must, size) == jalloc.preferred(avail, must, size)
    assert sorted(alloc.preferred(avail, [], 3)) == ["2", "4", "5"]


def test_manager_stop_reaches_restarted_plugin(manager, kubelet):
    plugin = manager.plugins()[0]
    plugin.restart()
    assert len(kubelet.registrations) == 2
    manager.stop()
    assert plugin.stopped
    assert not os.path.exists(plugin.socket_path)


def test_envvar_strategy_carries_full_guest_contract(kubelet, hgx, short_dir):
    # Without CDI, the response itself carries the nodes and the static env.
    mgr = PluginManager(make_config(hgx, kubelet, short_dir, strategies=("envvar",)))
    mgr.start()
    try:
        ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
        with ch:
            (cr,) = _allocate(stub, ["0", "1"]).container_responses
        paths = [d.host_path for d in cr.devices]
        assert paths == [os.path.join(hgx.dev, n) for n in (
            "nvidia0", "nvidia1", *C.SHARED_NODES)]
        assert all(d.permissions == "rw" for d in cr.devices)
        assert cr.envs[C.ENV_WORKER_ID] == "0"
        assert cr.envs[C.ENV_TPU_VISIBLE_CHIPS] == "0,1"
        assert not cr.cdi_devices and not cr.mounts
    finally:
        mgr.stop()


def test_driver_unbind_flips_unhealthy(manager, hgx):
    """An unbind removes the function's driver link while the stale /dev
    node lingers: Unhealthy though the node exists."""
    plugin = manager.plugins()[0]
    watcher = HealthWatcher([plugin], use_inotify=False)
    watcher.evaluate()
    assert all(d.health == glue.HEALTHY for d in plugin.state.snapshot())
    hgx.unbind_driver(bdf(5))
    watcher.evaluate()
    health = {d.id: d.health for d in plugin.state.snapshot()}
    assert health["5"] == glue.UNHEALTHY and health["0"] == glue.HEALTHY
    assert os.path.exists(os.path.join(hgx.dev, "nvidia5"))


def test_debug_report_snapshots_live_state(manager):
    rep = manager.debug_report()
    (gpu_plugin,) = [p for p in rep["plugins"] if p["resource"] == RESOURCE]
    assert gpu_plugin["serving"] and not gpu_plugin["stopped"]
    assert {d["id"] for d in gpu_plugin["devices"]} == {str(i) for i in range(8)}
    assert rep["gpu"]["gpus"] == 8 and rep["gpu"]["model"] == "H100_SXM5_80GB"
    assert rep["gpu"]["numa_nodes"] == [0] * 4 + [1] * 4
    assert rep["watcher_alive"]
    json.dumps(rep)  # directly serializable for the SIGUSR1 dump


class _CharStat:
    st_mode = stat_mod.S_IFCHR | 0o600


def _probe_as(monkeypatch, path, err):
    """os.stat/os.open in the health module: ``path`` is a char device
    whose open fails with ``err``."""
    real_stat, real_open = os.stat, os.open

    def _open(p, flags, *a):
        if p == path:
            raise OSError(err, os.strerror(err), p)
        return real_open(p, flags, *a)

    monkeypatch.setattr(H.os, "stat", lambda p, *a, **kw: _CharStat()
                        if p == path else real_stat(p, *a, **kw))
    monkeypatch.setattr(H.os, "open", _open)


def test_recovery_requires_live_driver(manager, hgx, monkeypatch):
    """Flipping back to Healthy is gated on the open probe: a node that
    reappears but answers ENXIO stays Unhealthy; a held one (EBUSY)
    recovers."""
    manager._watcher.stop()
    plugin = manager.plugins()[0]
    watcher = HealthWatcher([plugin], use_inotify=False)
    hgx.remove_dev_node("nvidia0")
    watcher.evaluate()
    assert {d.id: d.health for d in plugin.state.snapshot()}["0"] == glue.UNHEALTHY
    dev0 = hgx.add_dev_node("nvidia0")
    _probe_as(monkeypatch, dev0, errno.ENXIO)
    watcher.evaluate()
    assert {d.id: d.health for d in plugin.state.snapshot()}["0"] == glue.UNHEALTHY
    _probe_as(monkeypatch, dev0, errno.EBUSY)
    watcher.evaluate()
    assert {d.id: d.health for d in plugin.state.snapshot()}["0"] == glue.HEALTHY


def test_allocate_revalidates_driver_liveness(manager, kubelet, monkeypatch, hgx):
    """Allocate against an orphaned node (open -> ENXIO) fails closed; a
    held one (EBUSY) allocates."""
    dev0 = os.path.join(hgx.dev, "nvidia0")
    ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
    with ch:
        _probe_as(monkeypatch, dev0, errno.EBUSY)
        assert _allocate(stub, ["0"]).container_responses[0].cdi_devices
        _probe_as(monkeypatch, dev0, errno.ENXIO)
        with pytest.raises(grpc.RpcError) as exc:
            _allocate(stub, ["0"])
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert "liveness" in exc.value.details()


@pytest.mark.parametrize("err,alive", [(errno.EBUSY, True), (errno.EACCES, True),
                                       (errno.ENXIO, False), (errno.ENODEV, False)])
def test_node_alive_errno_classification(monkeypatch, tmp_path, err, alive):
    from kata_xpu_device_plugin_tpu.plugin import health as JH

    f = tmp_path / "plain"
    f.write_text("")
    assert H.node_alive(str(f)) and not H.node_alive(str(tmp_path / "missing"))
    for mod in (H, JH):
        monkeypatch.setattr(mod.os, "stat", lambda p: _CharStat())

        def _open(path, flags, err=err):
            raise OSError(err, os.strerror(err), path)

        monkeypatch.setattr(mod.os, "open", _open)
    assert H.node_alive("/dev/nvidia0") is alive is JH.node_alive("/dev/nvidia0")


class _FlakyPlugin:
    """Serving, socket gone, restart() fails a scripted number of times."""

    def __init__(self, short_dir, fail_times):
        self.resource_name = RESOURCE
        self.serving, self.stopped = True, False
        self.socket_path = os.path.join(short_dir, "never-created.sock")
        self.fail_times, self.calls = fail_times, 0
        self.state = type("S", (), {"snapshot": lambda self: []})()

    def restart(self):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise RuntimeError(f"kubelet not back (attempt {self.calls})")


def test_health_watcher_restart_retries_with_backoff(short_dir, tmp_path):
    plugin = _FlakyPlugin(short_dir, fail_times=2)
    now = [100.0]
    watcher = HealthWatcher([plugin], use_inotify=False, restart_backoff_s=1.0,
                            restart_backoff_max_s=8.0, clock=lambda: now[0])
    sink = obs.EventSink(str(tmp_path / "ev.jsonl"))
    prev = obs.set_default_sink(sink)
    try:
        calls = []
        for dt in (0.0, 0.0, 1.1, 1.1, 1.1, 0.01):
            now[0] += dt
            watcher.evaluate()
            calls.append(plugin.calls)
    finally:
        obs.set_default_sink(prev)
        sink.close()
    # fail (retry after 1 s), back off, fail (2 s), back off, succeed, and
    # with the socket still gone retry at once.
    assert calls == [1, 1, 2, 2, 3, 4]
    evs = [e for e in obs.read_events(str(tmp_path / "ev.jsonl"))
           if e.get("name") == "plugin_restart_failed"]
    assert [e["attempt"] for e in evs] == [1, 2]
    assert all(e["retry_in_s"] > 0 and "kubelet" in e["err"] for e in evs)
    text = obs_metrics.DEFAULT_REGISTRY.exposition()
    assert f'plugin_restarts_total{{resource="{RESOURCE}",ok="false"}}' in text
    assert f'plugin_restarts_total{{resource="{RESOURCE}",ok="true"}}' in text


def test_register_exhaustion_emits_event(short_dir, tmp_path):
    server = DevicePluginServer(
        resource_name=RESOURCE, state=DeviceState([]), allocator=None,
        socket_dir=short_dir,
        kubelet_socket=os.path.join(short_dir, "no-kubelet.sock"),
        register_attempts=2, register_backoff_s=0.01, register_dial_timeout_s=0.05,
    )
    sink = obs.EventSink(str(tmp_path / "ev.jsonl"))
    prev = obs.set_default_sink(sink)
    t0 = time.monotonic()
    try:
        with pytest.raises(grpc.FutureTimeoutError):
            server.register()
    finally:
        obs.set_default_sink(prev)
        sink.close()
    assert time.monotonic() - t0 < 5
    (ev,) = [e for e in obs.read_events(str(tmp_path / "ev.jsonl"))
             if e.get("name") == "registration_exhausted"]
    assert ev["resource"] == RESOURCE and ev["attempts"] == 2 and ev["err"]


def test_config_validation_and_register_plumbing(hgx, kubelet, short_dir):
    with pytest.raises(ValueError, match="register-attempts"):
        make_config(hgx, kubelet, short_dir, register_attempts=0)
    with pytest.raises(ValueError, match="register-backoff-s"):
        make_config(hgx, kubelet, short_dir, register_backoff_s=-1.0)
    for bad in (dict(kv_quant="int4"), dict(kv_layout="rows"),
                dict(sched_policy="lottery"), dict(decode_steps=-1),
                dict(serving_tp=1, serving_tp_min=2), dict(strategies=("nope",))):
        with pytest.raises(ValueError):
            make_config(hgx, kubelet, short_dir, **bad)
    mgr = PluginManager(make_config(hgx, kubelet, short_dir, register_attempts=7,
                                    register_backoff_s=0.25))
    mgr.start()
    try:
        assert kubelet.registered.wait(5)
        plugin = mgr.plugins()[0]
        assert (plugin.register_attempts, plugin.register_backoff_s) == (7, 0.25)
    finally:
        mgr.stop()


@pytest.mark.parametrize("membership,want", [
    (dict(worker_id=1, worker_hostnames=("a", "b")), ("1", "a,b")),
    (dict(metadata_dir="md"), ("1", "a,b")),
    (dict(worker_id=0), ("0", None)),
    (dict(worker_hostnames=("a",), node_name="a"), ("0", "a"))],
    ids=["flags", "metadata", "bare-id", "derived"])
def test_membership_overlays_the_started_spec(hgx, kubelet, short_dir, membership,
                                             want):
    """A started daemon's spec carries the resolved identity (the cases the
    manager once refused; their resolution is held to JAX's in
    ``tests/test_torch_multihost.py``)."""
    if "metadata_dir" in membership:
        md = os.path.join(short_dir, "md")
        os.makedirs(md)
        for name, text in (("worker-network-endpoints", "a:10.0.0.1:8476,b"),
                           ("agent-worker-number", "1")):
            Path(md, name).write_text(text)
        membership = dict(metadata_dir=md)
    mgr = PluginManager(make_config(hgx, kubelet, short_dir, cdi_format="json",
                                    **membership))
    mgr.start()
    try:
        assert kubelet.registered.wait(5)
        (path,) = [os.path.join(short_dir, "cdi", f)
                   for f in os.listdir(os.path.join(short_dir, "cdi"))]
        env = dict(e.split("=", 1) for e in cdi.load(path).container_edits.env)
        assert (env.get("TPU_WORKER_ID"), env.get("TPU_WORKER_HOSTNAMES")) == want
        assert mgr.debug_report()["gpu"]["worker_id"] == int(want[0])
    finally:
        mgr.stop()


def test_journal_reconciles_across_a_restart(hgx, kubelet, short_dir, tmp_path):
    """Every grant is journaled; a restarted daemon reconciles the journal
    against the GPUs it observes (a vanished one orphans its group) without
    a single Unhealthy flap."""
    state = str(tmp_path / "state")
    mgr = PluginManager(make_config(hgx, kubelet, short_dir, state_dir=state))
    mgr.start()
    try:
        ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
        with ch:
            _allocate(stub, ["1", "0"])
            _allocate(stub, ["6"])
    finally:
        mgr.stop()
    journal = AllocationJournal(os.path.join(state, "allocations.json"))
    assert journal.allocations(RESOURCE) == [("0", "1"), ("6",)]
    hgx.unbind_driver(bdf(6))
    sink = obs.EventSink(str(tmp_path / "ev.jsonl"))
    prev = obs.set_default_sink(sink)
    mgr = PluginManager(make_config(hgx, kubelet, short_dir, state_dir=state))
    try:
        mgr.start()
        assert all(d.health == glue.HEALTHY for d in mgr.plugins()[0].state.snapshot())
    finally:
        mgr.stop()
        obs.set_default_sink(prev)
        sink.close()
    evs = obs.read_events(str(tmp_path / "ev.jsonl"))
    assert [(e["name"], e["devices"]) for e in evs if e["name"].startswith("alloc_")] == [
        ("alloc_reconciled", "0,1"), ("alloc_orphaned", "6")]
    assert AllocationJournal(os.path.join(state, "allocations.json")).allocations(
        RESOURCE) == [("0", "1")]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_daemon_never_initializes_cuda(hgx, kubelet, short_dir):
    """The daemon's scan, spec write, plugin start and Allocate, run in a
    fresh process: ``torch.cuda.is_initialized()`` stays False throughout,
    and none of it imports the JAX package."""
    code = f"""
import json, sys, torch
from kata_xpu_device_plugin_tpu_torch.config import Config
from kata_xpu_device_plugin_tpu_torch.plugin import PluginManager
cfg = Config(sysfs_root={hgx.sysfs!r}, dev_root={hgx.dev!r}, proc_root={hgx.proc!r},
             cdi_dir={os.path.join(short_dir, "cdi")!r}, cdi_format="json",
             kubelet_socket_dir={kubelet.socket_dir!r}, state_dir="",
             rescan_interval_s=0, metrics_port=0)
mgr = PluginManager(cfg)
mgr.start()
resp = mgr.gpu_allocator().allocate(["0", "3"])
mgr.stop()
print(json.dumps({{"cuda": torch.cuda.is_initialized(),
                  "jax": any(m.split(".")[0] in ("jax", "kata_xpu_device_plugin_tpu")
                             for m in sys.modules),
                  "gpus": resp.envs["TPU_VISIBLE_CHIPS"]}}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env())
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.splitlines()[-1]) == {
        "cuda": False, "jax": False, "gpus": "0,3"}


def test_cli_run_serves_and_stops_on_sigterm(hgx, kubelet, short_dir):
    """``python -m kata_xpu_device_plugin_tpu_torch run`` against the fake
    host registers with the kubelet, answers Allocate, and exits 0 on
    SIGTERM with its socket removed."""
    cdi_dir = os.path.join(short_dir, "cdi")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kata_xpu_device_plugin_tpu_torch", "run",
         "--sysfs-root", hgx.sysfs, "--dev-root", hgx.dev, "--proc-root", hgx.proc,
         "--cdi-dir", cdi_dir, "--kubelet-socket-dir", kubelet.socket_dir,
         "--state-dir", "", "--metrics-port", "0", "--rescan-interval-s", "0",
         "--kv-quant", "int8", "--decode-steps", "8"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert kubelet.registered.wait(60), proc.stderr.read() if proc.poll() else ""
        (reg,) = kubelet.registrations
        ch, stub = kubelet.plugin_stub(reg.endpoint)
        with ch:
            (cr,) = _allocate(stub, ["7"]).container_responses
        assert cr.envs[C.ENV_KV_QUANT] == "int8" and cr.envs[C.ENV_DECODE_STEPS] == "8"
        assert os.path.exists(os.path.join(cdi_dir, "nvidia.com-gpu.yaml"))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not os.path.exists(os.path.join(kubelet.socket_dir, reg.endpoint))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_status_json(hgx, short_dir):
    """``status --json`` reports discovery and the specs on disk; without a
    kubelet on the pod-resources socket its pod section is the error."""
    res = subprocess.run(
        [sys.executable, "-m", "kata_xpu_device_plugin_tpu_torch", "status", "--json",
         "--sysfs-root", hgx.sysfs, "--dev-root", hgx.dev, "--proc-root", hgx.proc,
         "--cdi-dir", os.path.join(short_dir, "none"), "--state-dir", "",
         "--pod-resources-socket", os.path.join(short_dir, "no-kubelet.sock")],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    rep = json.loads(res.stdout)
    assert [g["index"] for g in rep["gpu"]["gpus"]] == list(range(8))
    assert rep["gpu"]["gpus"][2]["pci_address"] == bdf(2)
    assert rep["gpu"]["model"] == "H100_SXM5_80GB" and rep["cdi_specs"] == []
    assert rep["gpu"]["worker_hostnames"] == [] and rep["gpu"]["worker_id"] == 0
    assert "pod_assignments" not in rep and rep["pod_assignments_error"]
