"""Smoke wrappers over the port's race harness (``tests/torch_race_harness.py``):
each scenario once at a small size, one whole iteration, and the pin of the
re-registration fix (the plugin's own dials use a subchannel of their own,
so a peer's reconnect backoff never delays a re-registration)."""
import grpc

from kata_xpu_device_plugin_tpu_torch.plugin import server as plugin_server
from kata_xpu_device_plugin_tpu_torch.plugin.server import (
    DevicePluginServer,
    DeviceState,
    WatchedDevice,
)
from tests import torch_race_harness as harness


def test_race_journal_smoke(tmp_path):
    stats = harness.stress_journal(str(tmp_path), threads=2, ops=8, seed=3)
    assert stats["entries"] == stats["expected"] == 16


def test_race_aggregator_smoke(tmp_path):
    stats = harness.stress_aggregator(str(tmp_path), threads=2, ops=8, seed=3)
    assert stats["consumed"] == stats["expected"] == 16 and stats["servers"] == 2


def test_race_flight_smoke(tmp_path):
    stats = harness.stress_flight(str(tmp_path), threads=2, ops=8, seed=3)
    assert stats["events"] == stats["expected"] == 16 and len(stats["dumps"]) == 2


def test_race_metrics_smoke(tmp_path):
    stats = harness.stress_metrics(str(tmp_path), threads=2, ops=8, seed=3)
    assert stats["total"] == stats["expected"] == 16


def test_race_reregister_smoke(tmp_path):
    stats = harness.stress_reregister(str(tmp_path), threads=2, ops=4, seed=3,
                                      restarts=2)
    assert stats["registrations"] == 3
    assert all(s < harness.REREGISTER_DEADLINE_S for s in stats["reregister_s"])
    assert stats["allocations"] and stats["streams"]


def test_race_full_iteration(tmp_path):
    results = harness.run_iteration(seed=7, threads=2, ops=4, restarts=1,
                                    keep_dir=str(tmp_path / "artifacts"))
    assert [r["scenario"] for r in results] == [
        "journal", "aggregator", "flight", "metrics", "reregister"]
    kept = sorted(p.name for p in (tmp_path / "artifacts").iterdir())
    assert "race_journal.json" in kept and any(k.startswith("race_guest") for k in kept)


def test_plugin_dials_use_their_own_subchannel(monkeypatch):
    """The self-check of the plugin's socket and the registration dial
    never share a subchannel with a peer's channel to the same socket
    (that channel sits in reconnect backoff after every restart)."""
    root = harness._short_dir()
    kubelet = harness.StandInKubelet(root).start()
    dials = []
    real = grpc.insecure_channel

    def recording(target, options=None, *a, **kw):
        dials.append((target, dict(options or ())))
        return real(target, options, *a, **kw)

    monkeypatch.setattr(plugin_server.grpc, "insecure_channel", recording)
    plugin = DevicePluginServer(
        harness.RESOURCE, DeviceState([WatchedDevice("0")]), harness._Allocator(),
        socket_dir=root, register_backoff_s=0.05)
    try:
        plugin.start()
        plugin.restart()
        assert kubelet.wait_for(2, harness.REREGISTER_DEADLINE_S)
    finally:
        plugin.stop()
        kubelet.stop()
    assert {t.rsplit("/", 1)[-1] for t, _o in dials} == {
        "kubelet.sock", plugin.endpoint}
    assert len(dials) == 4
    assert all(o.get("grpc.use_local_subchannel_pool") == 1 for _t, o in dials)
