"""PyTorch port, daemon to guest: the GPU daemon allocates a GPU of a fake
host through the fake kubelet, and that allocation's env drives the port's
``GenerationServer(device="cpu")`` and the JAX package's server at the
tiny config: equal tokens, equal counters, the knobs the daemon set in both
servers' ``stats()``, and the allocation's trace id on every event of both
streams. The port's and JAX's ``HeartbeatAggregator`` take each stream into
equal snapshots, labelled with the granted GPU."""
from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import replace

import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu import obs as jobs
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.plugin.manager import HeartbeatAggregator as JaxAggregator
from kata_xpu_device_plugin_tpu_torch import obs as tobs
from kata_xpu_device_plugin_tpu_torch.cdi import constants as C
from kata_xpu_device_plugin_tpu_torch.config import Config
from kata_xpu_device_plugin_tpu_torch.discovery import FakeSysfsBuilder
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.plugin import HeartbeatAggregator, PluginManager
from kata_xpu_device_plugin_tpu_torch.plugin.api import deviceplugin_pb2 as pb

from .fake_kubelet import FakeKubelet
from .torch_parity import CONFIGS, numpy_pair

# The guest's server arguments that are not knobs (the knobs come from the
# allocation's env): the tiny config's shapes, a pool block of 8 tokens.
SERVER_KW = dict(max_batch=3, max_len=64, chunk=4, prefill_buckets=(16, 32),
                 kv_block_size=8)
# The daemon's knobs: a pool that preempts under the burst, int8 KV, two
# chunks a dispatch, a heartbeat every 2 rounds.
KNOBS = dict(kv_pool_tokens=8 * 12, kv_quant="int8", decode_steps=2,
             heartbeat_rounds=2)
LENGTHS = (10, 12, 9, 11, 8)
BUDGET = 16
# Counters of both servers' stats(); the arena's bytes show the int8 cache.
COUNTERS = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
            "preemptions", "decode_steps", "kv_pool_tokens", "kv_blocks_total",
            "arena_bytes", "tp_degree")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def allocation():
    """The env of one Allocate of GPU 1, over gRPC from the fake kubelet,
    with the daemon's knobs and a guest events dir."""
    d = tempfile.mkdtemp(prefix="kg-", dir="/tmp")
    fake = FakeSysfsBuilder(root=os.path.join(d, "host"))
    for i in range(2):
        fake.add_nvidia_gpu(i, f"0000:{0x19 + i:02x}:00.0", numa_node=0)
    kubelet = FakeKubelet(os.path.join(d, "kubelet")).start()
    events = os.path.join(d, "guest-events")
    mgr = PluginManager(Config(
        sysfs_root=fake.sysfs, dev_root=fake.dev, proc_root=fake.proc,
        cdi_dir=os.path.join(d, "cdi"), kubelet_socket_dir=kubelet.socket_dir,
        state_dir="", rescan_interval_s=0, health_poll_interval_s=3600,
        metrics_port=0, guest_events_dir=events, **KNOBS))
    mgr.start()
    try:
        ch, stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
        with ch:
            resp = stub.Allocate(pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(device_ids=["1"])]))
        yield dict(resp.container_responses[0].envs), events
    finally:
        mgr.stop()
        kubelet.stop()
        shutil.rmtree(d, ignore_errors=True)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def _serve(pkg, make, envs, monkeypatch, prompts):
    """One guest process's life under the allocation's env: the event sink
    resolved from that env (as at a guest's start), the server made, the
    requests served in two waves, the sink closed. Returns tokens, stats
    and the stream's events."""
    prev = pkg.default_sink()
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    sink = pkg.configure_from_env(force=True)
    try:
        srv = make()
        rids = [srv.submit(p, BUDGET) for p in prompts[:3]]
        srv.step()
        rids += [srv.submit(p, BUDGET) for p in prompts[3:]]
        res = srv.run()
        toks = [np.asarray(res[r]) for r in rids]
        stats = srv.stats()
    finally:
        sink.close()
        pkg.set_default_sink(prev)
    return toks, stats, pkg.read_events(envs[C.ENV_OBS_FILE])


@pytest.fixture(scope="module")
def served(allocation):
    """Both guests under the same env, one after the other; each stream
    moved into a directory of its own under its allocation's file name."""
    envs, events = allocation
    jcfg = replace(CONFIGS["tiny"](), n_layers=1)
    jp, tp, tcfg = numpy_pair(jcfg, seed=0)
    prompts = _prompts(tcfg.vocab_size)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for side, pkg, make in (
                ("torch", tobs, lambda: GenerationServer(tp, tcfg, device="cpu",
                                                         **SERVER_KW)),
                ("jax", jobs, lambda: JaxServer(jp, jcfg, **SERVER_KW))):
            toks, stats, evs = _serve(pkg, make, envs, mp, prompts)
            side_dir = os.path.join(events, side)
            os.makedirs(side_dir)
            os.replace(envs[C.ENV_OBS_FILE], os.path.join(
                side_dir, os.path.basename(envs[C.ENV_OBS_FILE])))
            out[side] = (toks, stats, evs, side_dir)
    finally:
        mp.undo()
    return out


def test_allocation_env_carries_the_knobs(allocation):
    envs, events = allocation
    assert envs[C.ENV_TPU_VISIBLE_CHIPS] == "1"
    assert envs[C.ENV_OBS] == "1"
    assert envs[C.ENV_OBS_FILE] == os.path.join(events, "guest_1.jsonl")
    assert {k: envs[k] for k in (C.ENV_KV_POOL_TOKENS, C.ENV_KV_QUANT,
                                 C.ENV_DECODE_STEPS, C.ENV_HEARTBEAT_ROUNDS)} == {
        C.ENV_KV_POOL_TOKENS: "96", C.ENV_KV_QUANT: "int8",
        C.ENV_DECODE_STEPS: "2", C.ENV_HEARTBEAT_ROUNDS: "2"}
    assert len(envs[C.ENV_TRACE_CTX]) == 16


def test_guests_give_jax_tokens_and_counters(served):
    (ttoks, tstats, _, _), (jtoks, jstats, _, _) = served["torch"], served["jax"]
    assert [t.tolist() for t in ttoks] == [t.tolist() for t in jtoks]
    assert all(len(t) == BUDGET for t in ttoks)
    assert {k: tstats[k] for k in COUNTERS} == {k: jstats[k] for k in COUNTERS}
    assert (tstats["kv_quant"], tstats["decode_steps"], tstats["heartbeat_rounds"]) == (
        "int8", 2, 2)
    assert tstats["kv_pool_tokens"] > 0  # paged: the pool from the env
    assert tstats["preemptions"] > 0 and tstats["heartbeats"] > 1
    heartbeats = {side: sum(e["name"] == "serving_heartbeat" for e in served[side][2])
                  for side in served}
    assert heartbeats["torch"] == heartbeats["jax"] == tstats["heartbeats"]


def test_every_event_carries_the_allocation_trace(served, allocation):
    trace = allocation[0][C.ENV_TRACE_CTX]
    for side in ("torch", "jax"):
        _, stats, evs, _ = served[side]
        assert stats["trace"] == trace
        assert evs and {e.get("trace") for e in evs} == {trace}, side
    names = {side: [e["name"] for e in served[side][2]] for side in served}
    assert names["torch"] == names["jax"]


def test_aggregators_agree_on_both_streams(served):
    for side in ("torch", "jax"):
        side_dir = served[side][3]
        agg, jagg = HeartbeatAggregator(side_dir), JaxAggregator(side_dir)
        n = agg.poll_once()
        assert n == jagg.poll_once() == served["torch"][1]["heartbeats"] > 0
        snap = agg.snapshot()
        assert snap == jagg.snapshot()
        (key,) = snap
        assert key.startswith("1/")  # labelled with the granted GPU
        assert agg.poll_once() == jagg.poll_once() == 0  # nothing new
