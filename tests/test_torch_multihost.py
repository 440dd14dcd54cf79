"""PyTorch port, multi-host membership of the GPU daemon against the JAX
package's: every resolver function on JAX's ``tests/test_multihost.py``
cases and on a seeded hypothesis sweep of hostname lists, endpoint strings,
env, metadata and state dirs (values and the state file's bytes); the
port's manager on a fake GPU host against JAX's on a fake TPU host with an
autodetected type (the only JAX path a GPU host can take: nothing fixes its
host count), from the same sources; ``status`` reporting the overlaid
identity and never writing state; the node-env identity of ``scan_gpus``;
the process-strided loader; the bench configs' fields."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kata_xpu_device_plugin_tpu.__main__ import main as jax_main
from kata_xpu_device_plugin_tpu.config import Config as JaxConfig
from kata_xpu_device_plugin_tpu.discovery import scan_tpus
from kata_xpu_device_plugin_tpu.discovery.sysfs import FakeSysfsBuilder as JaxFake
from kata_xpu_device_plugin_tpu.models import gemma as jgemma
from kata_xpu_device_plugin_tpu.models import llama as jllama
from kata_xpu_device_plugin_tpu.multihost import resolver as jres
from kata_xpu_device_plugin_tpu.parallel import loader as jloader
from kata_xpu_device_plugin_tpu.plugin.manager import PluginManager as JaxManager
from kata_xpu_device_plugin_tpu.plugin.manager import build_tpu_spec
from kata_xpu_device_plugin_tpu_torch import cdi, models
from kata_xpu_device_plugin_tpu_torch.__main__ import main as torch_main
from kata_xpu_device_plugin_tpu_torch.config import Config
from kata_xpu_device_plugin_tpu_torch.discovery import scan_gpus
from kata_xpu_device_plugin_tpu_torch.discovery.sysfs import FakeSysfsBuilder
from kata_xpu_device_plugin_tpu_torch.guest import distributed as tdist
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.multihost import resolver as tres
from kata_xpu_device_plugin_tpu_torch.parallel import loader as tloader
from kata_xpu_device_plugin_tpu_torch.plugin.manager import PluginManager, build_gpu_spec

HOSTS4 = ("t1v-n-abc-w-0", "t1v-n-abc-w-1", "t1v-n-abc-w-2", "t1v-n-abc-w-3")
IDENTITY = ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES")


@pytest.fixture(autouse=True)
def no_node_identity(monkeypatch):
    """Neither package sees this machine's own TPU_* env."""
    for k in list(os.environ):
        if k.startswith("TPU_"):
            monkeypatch.delenv(k)


def _write_metadata(d, endpoints, worker_number=None):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "worker-network-endpoints"), "w") as f:
        f.write(endpoints)
    if worker_number is not None:
        with open(os.path.join(d, "agent-worker-number"), "w") as f:
            f.write(str(worker_number))


def _view(mem):
    return None if mem is None else (mem.worker_id, mem.hostnames, mem.source)


def _state_bytes(d):
    path = os.path.join(d, "worker-identity.json")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


# ----- pure helpers --------------------------------------------------------


@pytest.mark.parametrize("fn,args", [
    ("canonical_order", ([f"slice-w-{i}" for i in (10, 2, 0, 11, 1)],)),
    ("canonical_order", (["b", "a", "b"],)),
    ("parse_worker_network_endpoints",
     ("t1v-w-0:10.130.0.9:8476, t1v-w-1:10.130.0.10:8476",)),
    ("parse_worker_network_endpoints", ("10.0.0.1:8476,10.0.0.2",)),
    ("parse_worker_network_endpoints", ("a.internal,b.internal",)),
    ("parse_worker_network_endpoints", ("0:127.0.0.1:8476,1:localhost:8476",)),
    ("_match_self", (("10.0.0.1", "10.0.0.9"), "10.0.0.9")),
    ("_match_self", (("10.0.0.1", "b"), "10.0.0.2")),
    ("_match_self", (("a.x.internal", "b.x.internal"), "b")),
    ("env_hostnames", ({"TPU_WORKER_HOSTNAMES": " a, ,b "},)),
    ("from_env", ({"TPU_WORKER_ID": "2"}, "x")),
    ("from_env", ({"TPU_WORKER_ID": "5", "TPU_WORKER_HOSTNAMES": "a,b"}, "x")),
    ("from_env", ({"TPU_WORKER_HOSTNAMES": "a,b"}, "nobody")),
    ("from_env", ({"TPU_WORKER_ID": "-1"}, "x")),
])
def test_helpers_match_jax(fn, args):
    got, want = getattr(tres, fn)(*args), getattr(jres, fn)(*args)
    if isinstance(want, jres.SliceMembership):
        got, want = _view(got), _view(want)
    assert got == want


# ----- the resolution ladder: JAX's cases, each in both packages ----------


def _resolve_both(tmp_path, env=None, metadata=None, state=None, steps=1, **kw):
    """Resolve in both packages from the same inputs, each in its own dirs;
    ``metadata`` is ``(endpoints, worker_number)`` or a list of them, one a
    step (None removes the dir), ``state`` a JSON payload written first.
    Returns the port's view and state bytes after each step, held equal to
    JAX's."""
    out = {}
    for name, mod in (("jax", jres), ("torch", tres)):
        root = tmp_path / name
        md, sd = str(root / "md"), str(root / "state")
        if state is not None:
            os.makedirs(sd)
            with open(os.path.join(sd, "worker-identity.json"), "w") as f:
                f.write(state)
        seen = []
        for step in (metadata if isinstance(metadata, list) else [metadata] * steps):
            shutil.rmtree(md, ignore_errors=True)
            if step is not None:
                _write_metadata(md, *step)
            mem = mod.resolve_membership(dict(env or {}), metadata_dir=md,
                                         state_dir=sd, **kw)
            seen.append((_view(mem), _state_bytes(sd)))
        out[name] = seen
    assert out["torch"] == out["jax"]
    return out["torch"]


RESOLVE_CASES = {
    "standalone": dict(hostname="solo"),
    "config-wins-over-env": dict(
        env={"TPU_WORKER_ID": "3", "TPU_WORKER_HOSTNAMES": "x,y,z,w"},
        hostname="h-w-1", explicit_worker_id=1, explicit_hostnames=HOSTS4),
    "env-unsorted": dict(env={"TPU_WORKER_ID": "2", "TPU_WORKER_HOSTNAMES": "c,a,b"},
                         hostname="zz"),
    "env-derived": dict(env={"TPU_WORKER_HOSTNAMES": "a,b,c"},
                        hostname="b.cluster.local"),
    "metadata": dict(metadata=(",".join(f"{h}:10.0.0.{i}:8476"
                                        for i, h in enumerate(HOSTS4)), 2),
                     hostname="unrelated"),
    "metadata-derived": dict(metadata=(",".join(HOSTS4), None),
                             hostname="t1v-n-abc-w-2"),
    "host-not-in-list": dict(hostname="stranger", explicit_hostnames=HOSTS4),
    "explicit-id-keeps-order": dict(hostname="x", explicit_worker_id=0,
                                    explicit_hostnames=("c", "a", "b")),
    "explicit-id-out-of-range": dict(env={"TPU_WORKER_HOSTNAMES": "a,b"},
                                     hostname="b", explicit_worker_id=7,
                                     explicit_hostnames=("a", "b")),
    "explicit-id-alone": dict(hostname="x", explicit_worker_id=2),
    "explicit-id-over-env": dict(
        env={"TPU_WORKER_HOSTNAMES": "a,b,c", "TPU_WORKER_ID": "1"},
        hostname="c", explicit_worker_id=2),
    "persist-then-outage": dict(metadata=[(",".join(HOSTS4), 3), None],
                                hostname="x"),
    "live-wins-over-stale": dict(metadata=[(",".join(HOSTS4), 1),
                                           (",".join(HOSTS4[:2]), 0)],
                                 hostname="x"),
    "repurposed-node": dict(state=json.dumps({"worker_id": 3,
                                              "hostnames": list(HOSTS4)}),
                            hostname="x", num_hosts_hint=1),
    "unchanged-state": dict(metadata=(",".join(HOSTS4), 1), steps=2, hostname="x"),
    "bare-env-id-merges-metadata": dict(env={"TPU_WORKER_ID": "2"},
                                        metadata=(",".join(HOSTS4), None),
                                        hostname="unmatched"),
    "bare-env-id-merges-state": dict(
        env={"TPU_WORKER_ID": "2"}, hostname="x",
        state=json.dumps({"worker_id": 2, "hostnames": list(HOSTS4)})),
    "persisted-peers-need-the-id": dict(
        env={"TPU_WORKER_ID": "0"}, hostname="x",
        state=json.dumps({"worker_id": 1, "hostnames": list(HOSTS4)})),
    "persisted-peers-respect-hint": dict(
        env={"TPU_WORKER_ID": "1"}, hostname="x", num_hosts_hint=1,
        state=json.dumps({"worker_id": 1, "hostnames": list(HOSTS4)})),
    "merge-rejects-unaddressable-id": dict(metadata=("a,b", None), hostname="zz",
                                           explicit_worker_id=5),
    "explicit-flag-id-merges-metadata": dict(metadata=("a,b,c", None),
                                             hostname="zz", explicit_worker_id=1),
    "ip-never-short-name-matches": dict(explicit_hostnames=("10.0.0.1", "10.0.0.2"),
                                        hostname="10.0.0.9"),
    "corrupt-state": dict(state="{not json", hostname="x"),
    "readonly-keeps-state": dict(state=json.dumps({"worker_id": 3, "hostnames":
                                                   list(HOSTS4)}),
                                 hostname="x", num_hosts_hint=1,
                                 state_readonly=True),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_membership_matches_jax(tmp_path, case):
    _resolve_both(tmp_path, **RESOLVE_CASES[case])


def test_sixteen_hosts_agree_without_a_coordinator(tmp_path):
    hosts = tuple(f"pod-w-{i}" for i in range(16))
    ids = {}
    for h in sorted(hosts, reverse=True):
        (((wid, got, _), _),) = _resolve_both(tmp_path / h, hostname=h,
                                               explicit_hostnames=list(hosts))
        assert got == tres.canonical_order(hosts)
        ids[h] = wid
    assert sorted(ids.values()) == list(range(16)) and ids["pod-w-10"] == 10


_HOST = st.sampled_from(["a", "b", "c", "h-w-0", "h-w-1", "h-w-2", "h-w-10",
                         "b.cluster.local", "10.0.0.1", "10.0.0.9", "x"])
_ENDPOINT = st.one_of(_HOST, st.tuples(st.integers(0, 5), _HOST, st.just("8476"))
                      .map(lambda t: f"{t[0]}:{t[1]}:{t[2]}"))


@settings(max_examples=200, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(env_id=st.one_of(st.none(), st.integers(-1, 5).map(str), st.just("x")),
       env_hosts=st.one_of(st.none(), st.lists(_HOST, max_size=4).map(",".join)),
       endpoints=st.one_of(st.none(), st.lists(_ENDPOINT, max_size=4).map(",".join)),
       md_number=st.one_of(st.none(), st.integers(0, 5).map(str), st.just("one")),
       flag_id=st.integers(-1, 4),
       flag_hosts=st.lists(_HOST, max_size=4, unique=True),
       hostname=_HOST,
       state=st.one_of(st.none(), st.tuples(st.integers(0, 4),
                                            st.lists(_HOST, max_size=4))),
       hint=st.integers(0, 3), outage=st.booleans())
def test_resolver_sweep_matches_jax(tmp_path_factory, env_id, env_hosts, endpoints,
                                    md_number, flag_id, flag_hosts, hostname,
                                    state, hint, outage):
    env = {k: v for k, v in (("TPU_WORKER_ID", env_id),
                             ("TPU_WORKER_HOSTNAMES", env_hosts)) if v is not None}
    metadata = None if endpoints is None else (endpoints, md_number)
    _resolve_both(
        tmp_path_factory.mktemp("sweep"), env=env,
        metadata=[metadata, None if outage else metadata],
        state=None if state is None else json.dumps(
            {"worker_id": state[0], "hostnames": state[1]}),
        hostname=hostname, explicit_worker_id=flag_id,
        explicit_hostnames=tuple(flag_hosts), num_hosts_hint=hint)


def test_state_file_bytes_match_jax(tmp_path):
    got = []
    for mod in (jres, tres):
        d = str(tmp_path / mod.__name__.replace(".", "_"))
        mod.save_state(d, mod.SliceMembership(1, HOSTS4, "metadata"))
        got.append(_state_bytes(d))
        assert _view(mod.load_state(d)) == (1, HOSTS4, "state")
    assert got[0] == got[1]
    assert json.loads(got[1]) == {"worker_id": 1, "hostnames": list(HOSTS4)}


# ----- the manager's overlay: the port on a GPU host, JAX autodetected -----


def _tpu_host(root):
    fake = JaxFake(root=root)
    for i in range(4):
        fake.add_accel_chip(i)
        fake.add_pci_function(f"0000:0{i}:05.0", "1ae0", "0062", numa_node=i // 2)
    return fake


def _gpu_host(root):
    fake = FakeSysfsBuilder(root=root)
    for i in range(4):
        fake.add_nvidia_gpu(i, f"0000:{0x18 + 0x10 * i:02x}:00.0", numa_node=i // 2)
    return fake


def _spec_identity(spec) -> dict:
    env = dict(e.split("=", 1) for e in spec.container_edits.env)
    return {k: env.get(k) for k in IDENTITY}


def _managers(tmp_path, monkeypatch, env=None, metadata=None, state=None,
              rounds=1, **flags):
    """Scan ``rounds`` times with each package's manager (a fresh manager a
    round, as a restarted daemon) from the same flags, node env, metadata
    (one entry a round; None removes it) and pre-written state. Returns
    the port's spec identity and state bytes after each round, held equal
    to JAX's."""
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    out = {}
    for name in ("jax", "torch"):
        root = tmp_path / name
        md, sd = str(root / "md"), str(root / "state")
        if state is not None:
            os.makedirs(sd)
            with open(os.path.join(sd, "worker-identity.json"), "w") as f:
                f.write(state)
        seen = []
        for step in (metadata if isinstance(metadata, list) else [metadata] * rounds):
            shutil.rmtree(md, ignore_errors=True)
            if step is not None:
                _write_metadata(md, *step)
            extra = dict(metadata_dir=md) if metadata is not None else {}
            if name == "jax":
                fake = _tpu_host(str(root / "host"))
                cfg = JaxConfig(sysfs_root=fake.sysfs, dev_root=fake.dev,
                                cdi_dir=str(root / "cdi"), state_dir=sd,
                                metrics_port=0, libtpu_host_path="", **extra, **flags)
                inv, _ = JaxManager(cfg).scan()
                spec = build_tpu_spec(inv, cfg)
            else:
                fake = _gpu_host(str(root / "host"))
                cfg = Config(sysfs_root=fake.sysfs, dev_root=fake.dev,
                             proc_root=fake.proc, cdi_dir=str(root / "cdi"),
                             state_dir=sd, metrics_port=0, **extra, **flags)
                inv, _ = PluginManager(cfg).scan()
                spec = build_gpu_spec(inv, cfg)
                assert inv.topology.num_hosts == max(1, len(
                    inv.topology.worker_hostnames))
            seen.append((_spec_identity(spec), _state_bytes(sd)))
        out[name] = seen
    assert out["torch"] == out["jax"]
    return out["torch"]


H2 = ("vp-w-0", "vp-w-1")
MANAGER_CASES = {
    "flags-derived": dict(worker_hostnames=H2, node_name="vp-w-1"),
    "flags-with-id": dict(worker_id=1, worker_hostnames=H2),
    "env": dict(env={"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": ",".join(H2)}),
    "env-derived-by-node-name": dict(env={"TPU_WORKER_HOSTNAMES": ",".join(H2)},
                                     node_name="vp-w-0"),
    "metadata": dict(metadata=(",".join(H2), 1)),
    "metadata-four-hosts": dict(metadata=(",".join(HOSTS4), 3)),
    "metadata-derived-by-node-name": dict(metadata=(",".join(H2), None),
                                          node_name="vp-w-1"),
    "bare-env-id-zero": dict(env={"TPU_WORKER_ID": "0"}),
    "bare-env-id-merges-metadata": dict(env={"TPU_WORKER_ID": "2"},
                                        metadata=(",".join(HOSTS4), None)),
    "pinned-id-merges-metadata": dict(worker_id=1, metadata=(",".join(H2), None)),
    "outage-keeps-persisted-identity": dict(metadata=[(",".join(H2), 1), None]),
    "drift-live-wins": dict(metadata=(",".join(HOSTS4), 2),
                            state=json.dumps({"worker_id": 0, "hostnames": list(H2)})),
    "refused-peers-never-persisted": dict(worker_id=5, metadata=("a,b", None)),
    "standalone": dict(),
}


@pytest.mark.parametrize("case", sorted(MANAGER_CASES))
def test_manager_overlay_matches_jax(tmp_path, monkeypatch, case):
    _managers(tmp_path, monkeypatch, **MANAGER_CASES[case])


def test_bare_nonzero_id_spec_is_copied_and_its_guest_refuses(tmp_path, monkeypatch):
    """A bare non-zero node id with no peer list: JAX writes
    ``TPU_WORKER_ID=<n>`` and no hostnames into the spec, and its guest
    refuses to start on that env. The port does both the same (ROADMAP
    Queue 3, "To check")."""
    ((ident, state),) = _managers(tmp_path, monkeypatch, env={"TPU_WORKER_ID": "3"})
    assert ident == {"TPU_WORKER_ID": "3", "TPU_WORKER_HOSTNAMES": None}
    assert state is None
    with pytest.raises(ValueError, match="TPU_WORKER_ID=3"):
        tdist.resolve({"TPU_WORKER_ID": "3"})


def test_rescan_rewrites_the_spec_when_the_identity_resolves_late(tmp_path):
    """A metadata agent that writes after the daemon started: the next rescan
    overlays the identity and rewrites the spec on disk (JAX
    ``rescan_once``)."""
    fake = _gpu_host(str(tmp_path / "host"))
    md = str(tmp_path / "md")
    cfg = Config(sysfs_root=fake.sysfs, dev_root=fake.dev, proc_root=fake.proc,
                 cdi_dir=str(tmp_path / "cdi"), cdi_format="json",
                 state_dir=str(tmp_path / "state"), metrics_port=0, metadata_dir=md)
    mgr = PluginManager(cfg)
    mgr.scan()
    (path,) = mgr.write_specs()
    assert _spec_identity(cdi.load(path)) == {"TPU_WORKER_ID": "0",
                                              "TPU_WORKER_HOSTNAMES": None}
    _write_metadata(md, ",".join(H2), 1)
    assert mgr.rescan_once() is True
    assert _spec_identity(cdi.load(path)) == {"TPU_WORKER_ID": "1",
                                              "TPU_WORKER_HOSTNAMES": ",".join(H2)}
    assert mgr.rescan_once() is False


def test_status_reports_the_identity_and_never_writes_state(tmp_path, capsys):
    """``status --json`` shows the identity the daemon would write, as JAX's
    ``status`` does on the same metadata, and touches no state; the
    pod-resources section reports its socket's failure."""
    md, state = str(tmp_path / "md"), str(tmp_path / "state")
    _write_metadata(md, ",".join(H2), 1)
    gpu, tpu = _gpu_host(str(tmp_path / "g")), _tpu_host(str(tmp_path / "t"))
    common = ["--cdi-dir", str(tmp_path / "cdi"), "--metadata-dir", md,
              "--state-dir", state, "--metrics-port", "0",
              "--pod-resources-socket", str(tmp_path / "none.sock")]
    assert torch_main(["status", "--json", "--sysfs-root", gpu.sysfs, "--dev-root",
                       gpu.dev, "--proc-root", gpu.proc, *common]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_main(["status", "--json", "--sysfs-root", tpu.sysfs, "--dev-root",
                     tpu.dev, "--libtpu-host-path", "", *common]) == 0
    want = json.loads(capsys.readouterr().out)
    for key in ("worker_id", "worker_hostnames", "num_hosts"):
        assert got["gpu"][key] == want["tpu"][key], key
    assert got["gpu"]["worker_hostnames"] == list(H2)
    assert not os.path.exists(state)
    assert "pod_assignments" not in got and got["pod_assignments_error"]
    assert torch_main(["status", "--sysfs-root", gpu.sysfs, "--dev-root", gpu.dev,
                       "--proc-root", gpu.proc, *common]) == 0
    text = capsys.readouterr().out
    assert "worker 1 of 2 host(s)" in text and "workers: vp-w-0,vp-w-1" in text
    assert "pod-resources: unavailable" in text and not os.path.exists(state)


def test_node_name_flag_and_env_form(monkeypatch):
    import argparse

    from kata_xpu_device_plugin_tpu_torch.config import add_flags, from_args

    monkeypatch.setenv("KATA_TPU_NODE_NAME", "node-7")
    p = argparse.ArgumentParser()
    add_flags(p)
    assert from_args(p.parse_args([])).node_name == "node-7"
    assert from_args(p.parse_args(["--node-name", "n2"])).node_name == "n2"
    for bad in (dict(worker_hostnames=("a", "a")),
                dict(worker_id=2, worker_hostnames=("a", "b"))):
        with pytest.raises(ValueError):
            Config(**bad)
        with pytest.raises(ValueError):
            JaxConfig(**bad)


# ----- the node env's identity in discovery --------------------------------


@pytest.mark.parametrize("env", [
    {"TPU_WORKER_HOSTNAMES": "a,b,c,d"},
    {"TPU_WORKER_HOSTNAMES": "a,b,c,d", "TPU_WORKER_ID": "2"},
    {"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "5"},
    {"TPU_WORKER_HOSTNAMES": "a,b", "HOSTNAME": "b"},
    {"TPU_WORKER_ID": "3"},
    {},
], ids=["hostnames-without-id", "id-and-hostnames", "unaddressable-id",
        "derived-by-hostname", "bare-id", "none"])
def test_scan_gpus_reads_the_node_identity_as_jax(tmp_path, env):
    tfake = _tpu_host(str(tmp_path / "t"))
    tpu = scan_tpus(tfake.sysfs, tfake.dev, env=env).topology
    fake = _gpu_host(str(tmp_path / "g"))
    gpu = scan_gpus(fake.sysfs, fake.dev, fake.proc, env=env).topology
    assert (gpu.worker_id, gpu.worker_hostnames) == (tpu.worker_id,
                                                     tpu.worker_hostnames)
    off = scan_gpus(fake.sysfs, fake.dev, fake.proc, env=env,
                    resolve_env_identity=False).topology
    assert (off.worker_id, off.worker_hostnames) == (0, ())


# ----- the process-strided loader ------------------------------------------


@pytest.mark.parametrize("host_count,host_index", [(2, 0), (2, 1), (4, 0), (4, 3)])
def test_loader_strides_match_jax(host_count, host_index):
    """Each process's rows, across an epoch's end, and a resume from the
    cursor mid-epoch, as JAX's ``make_loader`` gives them."""
    stream = np.random.default_rng(0).integers(0, 1000, 23 * 17).astype(np.int32)
    kw = dict(host_count=host_count, host_index=host_index, seed=3)
    jl = jloader.make_loader(stream, 8, 16, **kw)
    tl = tloader.make_loader(stream, 8, 16, **kw)
    for _ in range(5):  # 2 steps an epoch: across two epochs' ends
        a, b = next(jl), next(tl)
        assert b.dtype == np.int32 and b.shape == (8 // host_count, 17)
        np.testing.assert_array_equal(b, a)
    assert tl.state_dict() == jl.state_dict()
    resumed = tloader.make_loader(stream, 8, 16, **kw)
    resumed.load_state_dict(tl.state_dict())
    for _ in range(3):
        np.testing.assert_array_equal(next(resumed), next(jl))


def test_loader_strides_cover_the_global_batch():
    stream = np.arange(16 * 9, dtype=np.int32)
    whole = next(tloader.make_loader(stream, 8, 8, host_count=1, host_index=0))
    parts = [next(tloader.make_loader(stream, 8, 8, host_count=4, host_index=i))
             for i in range(4)]
    merged = np.empty_like(whole)
    for i, p in enumerate(parts):
        merged[i::4] = p
    np.testing.assert_array_equal(merged, whole)
    for bad in (dict(host_count=3, host_index=0), dict(host_count=2, host_index=2)):
        with pytest.raises(ValueError):
            tloader.make_loader(stream, 8, 8, **bad)


def test_make_loader_defaults_to_the_process_group(monkeypatch):
    """Without ``host_count``/``host_index`` the stride follows
    ``torch.distributed``'s world size and rank, as JAX's follows
    ``jax.process_count``/``process_index``; without a group, 1 and 0."""
    stream = np.arange(16 * 9, dtype=np.int32)
    solo = tloader.make_loader(stream, 8, 8)
    assert (solo.host_count, solo.host_index) == (1, 0)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 2)
    grouped = tloader.make_loader(stream, 8, 8)
    assert (grouped.host_count, grouped.host_index) == (4, 2)
    np.testing.assert_array_equal(next(grouped), next(jloader.make_loader(
        stream, 8, 8, host_count=4, host_index=2)))


# ----- the bench configs ---------------------------------------------------


@pytest.mark.parametrize("name,jax_fn", [
    ("gemma_2b_bench", jgemma.gemma_2b_bench),
    ("llama3_train_bench", jllama.llama3_train_bench),
])
def test_bench_configs_match_jax(name, jax_fn):
    want = bridge.config_from_fields(dataclasses.asdict(jax_fn()))
    assert getattr(models, name)() == want
    assert getattr(models, name)(n_layers=2).n_layers == 2
    assert name in models.__all__
