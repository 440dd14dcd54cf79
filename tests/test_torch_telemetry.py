"""PyTorch port, serving and training telemetry against the JAX package's:
the port's server and JAX's on the same weights and requests, with
``heartbeat_rounds=2`` and a sink each, over five configurations (slotted;
paged with the prefix cache and the host tier; persistent; ``slo_chunked``
fused; ``tp=2`` blocks). The event streams carry the same names in the same
order with equal deterministic fields; the request traces agree and their
phases sum to their wall time; the daemon's ``HeartbeatAggregator`` and
``tools/obs_report.py`` read the port's stream as JAX's; tokens do not
change with telemetry off or strict on. Then the trace context, the
knob-degrade events, the tripwire, ``export_metrics`` and ``fit``'s
``train.step`` spans. The JAX streams are made once per module."""
from __future__ import annotations

import json
from dataclasses import replace

import numpy as np
import pytest
import torch
from kata_xpu_device_plugin_tpu import obs as jobs
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu_torch import obs as tobs
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from tools.obs_report import build_report, check_schema

from .torch_parity import CONFIGS, build_pair

BASE = dict(max_batch=3, max_len=64, chunk=4, prefill_buckets=(16, 32),
            kv_quant=True, heartbeat_rounds=2)
# A pool that preempts under the burst.
POOL = dict(kv_block_size=8, kv_pool_tokens=8 * 12)
SERVERS = {
    "slotted": {},
    "paged_prefix_host": dict(POOL, prefix_cache_tokens=1, kv_host_tokens=512),
    "persistent": dict(persistent=True),
    "slo_chunked_fused": dict(sched_policy="slo_chunked", itl_slo_ms=0,
                              prefill_chunk=8),
    "tp2_blocks": dict(POOL, tp=2, kv_layout="blocks"),
}
LENGTHS = (10, 12, 9, 11, 8)
BUDGET = 16

# JAX event names of modes the port does not have yet (items 9b, 11b).
NOT_PORTED = {"checkpoint", "recovery", "chip_loss_fatal", "fatal_error",
              "fence_timeout_disabled", "quarantine_k_invalid",
              "recovery_backoff_invalid", "tp_degraded", "spec_disabled",
              "spec_round", "tp_overlap_disabled"}
# The tripwire's compiles are each package's own (JAX: an XLA compile of a
# shape the warm-up drain never ran, such as a prefill batch of 3; the
# eager port: a decode signature or graph never built), so its breach
# event and counts are compared apart (the tripwire test).
TRIPWIRE = {"tripwire_breach", "steady_state_compiles", "steady_state_reshards"}
# The JAX TP server's overlapped collectives across chips; the port's shards
# share one device and sum in place (serving_config reports 0).
JAX_ONLY = {"tp_overlap"}
# Fields that carry times, rates, ids or the label (a store's events carry
# its server's as ``store``): they differ run to run.
TIMED = {"ts", "trace", "span", "parent", "server", "store", "mfu",
         "device_busy_frac", "tokens_per_s", "projected_itl_ms", "error"}
BACKENDS = {"xla_reference": "reference", "pallas_paged": "cuda_paged"}


def _deterministic(ev: dict) -> dict:
    out = {}
    for k, v in ev.items():
        if (k in TIMED or k in TRIPWIRE or k in JAX_ONLY
                or k.endswith(("_s", "_ms"))
                or k.startswith("hbm_")):
            continue
        out[k] = BACKENDS.get(v, v) if k == "backend" else v
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """One layer: the streams do not depend on depth, and the JAX servers'
    compiles (most of this file's time) shrink with it."""
    jcfg = replace(CONFIGS["tiny"](), n_layers=1)
    return (jcfg,) + build_pair(jcfg, seed=0, fused=True)


def _prompts(vocab):
    rng = np.random.default_rng(1)
    head = rng.integers(0, vocab, 16).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, n).astype(np.int32)])
            for n in LENGTHS]


def _drive(srv, prompts):
    """A warm request to its end (the tripwire's warm-up drain, and the
    prefix it caches), then two waves: the second arrives while the first
    decodes (so a chunked admission defers, or a pool preempts). Tokens in
    submit order."""
    warm, *rest = prompts
    r = srv.submit(warm, 4)
    out = [srv.run()[r]]
    rids = [srv.submit(p, BUDGET) for p in rest[:2]]
    srv.step()
    srv.step()
    rids += [srv.submit(p, BUDGET) for p in rest[2:]]
    res = srv.run()
    return out + [np.asarray(res[r]) for r in rids]


def _capture(pkg, fn, path):
    sink = pkg.EventSink(path)
    prev = pkg.set_default_sink(sink)
    try:
        result = fn()
    finally:
        pkg.set_default_sink(prev)
        sink.close()
    return result, pkg.read_events(path)


def _watchdog(pkg):
    """The watchdog with its rules that read times (ITL burn, tokens/s
    regression, dispatch gaps) switched off: they fire on when a run is
    slow, not on what it does, so two runs' streams could differ."""
    return pkg.SLOBurnWatchdog(pkg.WatchdogConfig(
        slo_ms=0.0, regress_ratio=0.0, gap_ratio=1e12))


@pytest.fixture(scope="module")
def streams(model, tmp_path_factory):
    """``{config: {"jax"|"torch": (tokens, events, stats)}}``, each server
    run once."""
    jcfg, jp, tp, tcfg = model
    d = tmp_path_factory.mktemp("streams")
    prompts = _prompts(tcfg.vocab_size)
    out = {}
    for name, extra in SERVERS.items():
        kw = dict(BASE, **extra)
        runs = {}
        for side, pkg, make in (
                ("jax", jobs, lambda: JaxServer(jp, jcfg, watchdog=_watchdog(
                    jobs), **kw)),
                ("torch", tobs, lambda: GenerationServer(
                    tp, tcfg, device="cpu", watchdog=_watchdog(tobs), **kw))):
            def run(make=make):
                srv = make()
                return _drive(srv, prompts), srv.stats()

            (toks, stats), evs = _capture(pkg, run, str(d / f"{name}_{side}.jsonl"))
            runs[side] = (toks, evs, stats)
        out[name] = runs
    return out


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_event_stream_matches_jax(streams, name):
    """The same event names in the same order, with equal deterministic
    fields (times, rates, ids and the label left out; the decode backend's
    name mapped to the port's), and tokens equal to JAX's."""
    runs = streams[name]
    for want, got in zip(runs["jax"][0], runs["torch"][0]):
        np.testing.assert_array_equal(got, want)
    jev = [e for e in runs["jax"][1] if e["name"] not in NOT_PORTED | TRIPWIRE]
    tev = [e for e in runs["torch"][1] if e["name"] not in TRIPWIRE]
    assert [e["name"] for e in tev] == [e["name"] for e in jev]
    for j, t in zip(jev, tev):
        assert _deterministic(t) == _deterministic(j), (j["name"], j, t)
    names = {e["name"] for e in tev}
    assert {"serving_config", "serving_heartbeat", "request_trace", "ttft",
            "decode_attn_backend", "serving.decode_chunk"} <= names
    assert runs["torch"][2]["heartbeats"] == runs["jax"][2]["heartbeats"] > 1


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_request_traces_match_jax(streams, name):
    """One ``request_trace`` a request, equal to JAX's in its deterministic
    fields, whose phases sum to its wall time within 5% (the JAX
    invariant), and the ledger's ``stats()`` summaries."""
    runs = streams[name]
    rows = {}
    for side in ("jax", "torch"):
        traces = [e for e in runs[side][1] if e["name"] == "request_trace"]
        rows[side] = [_deterministic(e) for e in traces]
        for e in traces:
            phases = sum(e[f"{p}_s"] for p in (
                "queue", "prefill", "decode", "decode_degraded", "preempted",
                "recovery"))
            assert abs(phases - e["wall_s"]) <= 0.05 * e["wall_s"] + 1e-6, e
    assert rows["torch"] == rows["jax"]
    assert len(rows["torch"]) == len(LENGTHS)
    st = runs["torch"][2]
    assert st["request_traces"] == len(LENGTHS)
    assert st["request_phase_s"]["decode"]["count"] == len(LENGTHS)
    assert set(st["request_phase_s"]) == set(runs["jax"][2]["request_phase_s"])


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_daemon_readers_take_the_stream(streams, name, tmp_path):
    """``tools/obs_report.py`` builds a report from the port's stream that
    passes ``check_schema`` with data required, with JAX's report keys; the
    daemon's ``HeartbeatAggregator`` consumes its heartbeats into the same
    gauges as JAX's."""
    from kata_xpu_device_plugin_tpu.plugin.manager import HeartbeatAggregator
    from kata_xpu_device_plugin_tpu.utils import metrics

    runs = streams[name]
    reports = {side: build_report(runs[side][1], source=side)
               for side in ("jax", "torch")}
    assert check_schema(reports["torch"], require_data=True) == []
    for section in ("heartbeats", "requests", "incidents"):
        assert set(reports["torch"][section]) == set(reports["jax"][section])
    (tsec,) = reports["torch"]["heartbeats"]["servers"].values()
    (jsec,) = reports["jax"]["heartbeats"]["servers"].values()
    assert set(tsec) == set(jsec) and tsec["count"] == jsec["count"]
    assert set(tsec["utilization"]) == set(jsec["utilization"])
    for side, alloc in (("torch", "90-91"), ("jax", "92-93")):
        with open(tmp_path / f"guest_{alloc}.jsonl", "w") as fh:
            for ev in runs[side][1]:
                fh.write(json.dumps(ev) + "\n")
    agg = HeartbeatAggregator(str(tmp_path), poll_interval_s=0.01)
    n_hb = {side: sum(e["name"] == "serving_heartbeat" for e in runs[side][1])
            for side in runs}
    assert agg.poll_once() == n_hb["torch"] + n_hb["jax"]
    for side, alloc in (("torch", "90,91"), ("jax", "92,93")):
        server = runs[side][2]["trace"] and next(
            e["server"] for e in runs[side][1]
            if e["name"] == "serving_heartbeat")
        labels = dict(allocation=alloc, server=server)
        for gauge in (metrics.guest_tokens_per_s, metrics.guest_mfu,
                      metrics.guest_batch_occupancy):
            assert gauge.labels(**labels)._value.get() >= 0


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_tokens_equal_telemetry_off_and_strict(streams, model, name):
    """Greedy tokens are the same with telemetry off (no heartbeat, ledger,
    watchdog or tripwire) and strict mode on as with telemetry on."""
    _, _, tp, tcfg = model
    prompts = _prompts(tcfg.vocab_size)
    srv = GenerationServer(tp, tcfg, device="cpu", **dict(
        BASE, **SERVERS[name], heartbeat_rounds=0, tripwire=False, strict=True))
    for w, g in zip(streams[name]["torch"][0], _drive(srv, prompts)):
        np.testing.assert_array_equal(g, w)
    st = srv.stats()
    assert st["heartbeats"] == 0 and st["tripwire_warmed"] == 1 and srv.strict
    assert st["devledger"]["armed"] == 0 and srv._watchdog is None


def test_tripwire_steady_state_and_negative_control(streams, model, tmp_path):
    """Every configuration's second ``run()`` counts no compile and no
    reshard; so does JAX's once its process has compiled the traffic's
    shapes (a fresh slotted server after the streams' runs). The port's
    negative control: a persistent server whose warm-up drain never fused
    makes its first fused dispatch in steady state, a decode signature it
    never built (on the card, a graph capture): one compile, and a
    ``tripwire_breach``."""
    for name, runs in streams.items():
        st = runs["torch"][2]
        assert st["tripwire_warmed"] == runs["jax"][2]["tripwire_warmed"] == 1
        assert (st["steady_state_compiles"], st["steady_state_reshards"]) \
            == (0, 0), (name, st["steady_state_compiles"])
    jcfg, jp, tp, tcfg = model
    prompts = _prompts(tcfg.vocab_size)
    jsrv = JaxServer(jp, jcfg, **BASE)
    _drive(jsrv, prompts)
    assert (jsrv.stats()["steady_state_compiles"],
            jsrv.stats()["steady_state_reshards"]) == (0, 0)
    srv = GenerationServer(tp, tcfg, device="cpu", persistent=True,
                           sched_policy="slo_chunked", itl_slo_ms=0,
                           prefill_chunk=8, **BASE)

    def run():
        srv.submit(prompts[0][:8], 2)
        srv.run()  # the warm-up: one persistent round, nothing to fuse
        srv.submit(prompts[1], BUDGET)
        srv.step()  # decoding when the next request arrives
        srv.submit(prompts[2], BUDGET)
        srv.run()  # its admission is chunked, its slices fused

    _, evs = _capture(tobs, run, str(tmp_path / "tw.jsonl"))
    st = srv.stats()
    assert st["fused_admissions"] > 0
    assert st["steady_state_compiles"] == 1 and st["steady_state_reshards"] == 0
    breach = [e for e in evs if e["name"] == "tripwire_breach"]
    assert [(e["compiles"], e["reshards"]) for e in breach] == [(1, 0)]


def test_trace_context_is_adopted(model, monkeypatch, tmp_path):
    """``KATA_TPU_TRACE_CTX`` becomes the trace id of every event and span
    the server emits, as in JAX; without it the server mints one."""
    _, _, tp, tcfg = model
    monkeypatch.setenv("KATA_TPU_TRACE_CTX", "allocation-trace-7")

    def run():
        srv = GenerationServer(tp, tcfg, device="cpu", **BASE)
        srv.submit(np.arange(1, 9, dtype=np.int32), 3)
        srv.run()
        return srv

    srv, evs = _capture(tobs, run, str(tmp_path / "trace.jsonl"))
    assert srv.stats()["trace"] == "allocation-trace-7"
    assert evs and {e["trace"] for e in evs} == {"allocation-trace-7"}
    monkeypatch.delenv("KATA_TPU_TRACE_CTX")
    other = GenerationServer(tp, tcfg, device="cpu", **BASE).stats()["trace"]
    assert len(other) == 16 and other != "allocation-trace-7"


# Bad daemon-injected env values and the degrade events both servers emit.
BAD_ENV = {
    "KATA_TPU_KV_QUANT": ("int4", {}),
    "KATA_TPU_SCHED_POLICY": ("lottery", {}),
    "KATA_TPU_PREFILL_CHUNK": ("lots", dict(sched_policy="slo_chunked")),
    "KATA_TPU_ITL_SLO_MS": ("fast", {}),
    "KATA_TPU_DECODE_STEPS": ("-2", {}),
    "KATA_TPU_FUSED": ("maybe", dict(sched_policy="slo_chunked")),
    "KATA_TPU_PERSISTENT": ("yes", {}),
    "KATA_TPU_KV_LAYOUT": ("rows", dict(kv_pool_tokens=8 * 16, kv_block_size=8)),
    "KATA_TPU_KV_HOST_TOKENS": ("-4", dict(kv_pool_tokens=8 * 16,
                                           kv_block_size=8)),
    "KATA_TPU_KV_POOL_TOKENS": ("16k", {}),
    "KATA_TPU_PREFIX_CACHE_TOKENS": ("16k", {}),
    "KATA_TPU_HEARTBEAT_ROUNDS": ("often", dict(heartbeat_rounds=None)),
    "KATA_TPU_TP": ("two", {}),
    "KATA_TPU_DECODE_ATTN": ("flash", {}),
}


@pytest.mark.parametrize("env", sorted(BAD_ENV))
def test_bad_env_values_give_the_jax_degrade_events(model, env, monkeypatch,
                                                    tmp_path):
    """A malformed daemon-injected knob degrades, and both servers say so
    with the same event and reason."""
    jcfg, jp, tp, tcfg = model
    raw, extra = BAD_ENV[env]
    monkeypatch.setenv(env, raw)
    kw = {**BASE, **extra}
    kw = {k: v for k, v in kw.items() if v is not None}
    if env == "KATA_TPU_KV_QUANT":
        kw.pop("kv_quant")
    got = {}
    for side, pkg, make in (
            ("jax", jobs, lambda: JaxServer(jp, jcfg, **kw)),
            ("torch", tobs, lambda: GenerationServer(tp, tcfg, device="cpu",
                                                     **kw))):
        _, evs = _capture(pkg, make, str(tmp_path / f"{side}.jsonl"))
        got[side] = sorted(
            (e["name"], e.get("reason")) for e in evs
            if e["name"].endswith(("_invalid", "_disabled"))
            and e["name"] not in NOT_PORTED)
    assert got["torch"] == got["jax"] and got["jax"], got


def test_export_metrics_gives_the_jax_families(model):
    """``export_metrics`` exposes the JAX server's metric families with
    their types and label names (``prometheus_client`` parses both)."""
    from prometheus_client import generate_latest
    from prometheus_client.parser import text_string_to_metric_families

    from kata_xpu_device_plugin_tpu.obs import metrics as jmetrics

    jcfg, jp, tp, tcfg = model
    jax_srv = JaxServer(jp, jcfg, **BASE)
    jax_srv.export_metrics(label="fam_jax")
    port_srv = GenerationServer(tp, tcfg, device="cpu", **BASE)
    port_srv.export_metrics(label="fam_port")

    def families(text, server):
        out = {}
        for fam in text_string_to_metric_families(text):
            labels = [s.labels for s in fam.samples
                      if s.labels.get("server") == server]
            if fam.name.startswith("kata_tpu_serving") and labels:
                out[fam.name] = (fam.type, sorted({tuple(sorted(
                    k for k in lab if k != "le")) for lab in labels}))
        return out

    want = families(generate_latest(jmetrics.DEFAULT_REGISTRY.registry)
                    .decode(), "fam_jax")
    for fam in ("crash_recoveries", "requests_quarantined", "fence_stalls"):
        for suffix in ("", "_created"):  # crash recovery's (item 9b)
            del want[f"kata_tpu_serving_{fam}{suffix}"]
    got = families(tobs.DEFAULT_REGISTRY.exposition(), "fam_port")
    assert set(got) == set(want)
    for name, (kind, labels) in want.items():
        assert got[name][0] == kind, name
        if name != "kata_tpu_serving_decode_attn_backend":
            assert got[name][1] == labels, name
    text = tobs.DEFAULT_REGISTRY.exposition()
    assert 'kata_tpu_serving_rounds{server="fam_port"}' in text
    assert 'kata_tpu_serving_hbm_headroom_bytes{server="fam_port"} NaN' in text


def test_fit_emits_the_jax_train_step_fields(tmp_path):
    """``fit`` with a sink: one ``train.step`` span a step with the fields
    JAX's ``fit`` gives (a first step marked ``includes_compile``, tokens,
    the loss it returns, the gradient norm), the
    ``derived``/``train.compile_estimate`` event, and the train gauges;
    without a sink, the same losses and no event. JAX's ``fit`` runs a
    numpy step here: its span schema does not depend on the step, and the
    losses of the two packages' steps are the trainer suite's matter."""
    from kata_xpu_device_plugin_tpu.parallel import fit as jax_fit
    from kata_xpu_device_plugin_tpu.parallel.loader import (
        TokenBatchLoader as JaxLoader,
    )
    from kata_xpu_device_plugin_tpu_torch.models import llama3_train_test
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        TokenBatchLoader,
        fit,
        make_train_step,
        trainer,
    )

    tcfg = llama3_train_test(dtype=torch.float32)
    data = np.arange(4096, dtype=np.int32) % tcfg.vocab_size
    init_t, step_t = make_train_step(tcfg, aux_metrics=True, device="cpu")

    def numpy_step(state, batch):
        return state + 1, np.float32(5.0 - state), {"grad_norm": np.float32(2)}

    runs = {}
    for side, pkg, call in (
            ("torch", tobs, lambda: fit(init_t, step_t, TokenBatchLoader(
                data, batch=2, seq_len=15, seed=0), steps=3)),
            ("jax", jobs, lambda: jax_fit(lambda key: 0, numpy_step, JaxLoader(
                data, batch=2, seq_len=15, seed=0), steps=3))):
        (_state, losses), evs = _capture(pkg, call, str(tmp_path / f"{side}.jsonl"))
        runs[side] = (losses, evs)
    shapes = {}
    for side, (losses, evs) in runs.items():
        steps = [e for e in evs if e["name"] == "train.step"]
        assert [e["step"] for e in steps] == [1, 2, 3]
        assert [e["loss"] for e in steps] == [round(x, 6) for x in losses]
        assert all(e["grad_norm"] > 0 and e["tokens_per_s"] > 0 for e in steps)
        shapes[side] = [(sorted(e), e["tokens"], e.get("includes_compile"))
                        for e in steps]
        (est,) = [e for e in evs if e["kind"] == "derived"]
        assert est["name"] == "train.compile_estimate"
        assert est["first_step_s"] > 0 and est["steady_step_s"] > 0
        assert est["dur_s"] == pytest.approx(
            max(0.0, est["first_step_s"] - est["steady_step_s"]), abs=2e-6)
    assert shapes["torch"] == shapes["jax"]
    assert trainer._loss_gauge._only().get() == pytest.approx(
        runs["torch"][0][-1], abs=1e-6)
    prev = tobs.set_default_sink(None)
    try:
        _state, losses = fit(init_t, step_t, TokenBatchLoader(
            data, batch=2, seq_len=15, seed=0), steps=3)
    finally:
        tobs.set_default_sink(prev)
    assert losses == runs["torch"][0]
