"""PyTorch port, telemetry's host modules (``obs/`` and ``compat/``) against
the JAX package's on the same inputs: the event sink line by line, its
readers across a rotation, the flight ring, the metrics exposition parsed
by ``prometheus_client``, spans, the watchdog over the JAX suite's
heartbeat scenarios round by round, the device ledger over a scripted
clock, the profiler window, and strict mode and the tripwire on the CPU."""
from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch
from prometheus_client import CollectorRegistry, generate_latest
from prometheus_client.parser import text_string_to_metric_families

from kata_xpu_device_plugin_tpu.obs import devledger as j_devledger
from kata_xpu_device_plugin_tpu.obs import events as j_events
from kata_xpu_device_plugin_tpu.obs import flight as j_flight
from kata_xpu_device_plugin_tpu.obs import metrics as j_metrics
from kata_xpu_device_plugin_tpu.obs import trace as j_trace
from kata_xpu_device_plugin_tpu.obs import watchdog as j_watchdog
from kata_xpu_device_plugin_tpu_torch.compat import torchapi
from kata_xpu_device_plugin_tpu_torch.obs import devledger as t_devledger
from kata_xpu_device_plugin_tpu_torch.obs import events as t_events
from kata_xpu_device_plugin_tpu_torch.obs import flight as t_flight
from kata_xpu_device_plugin_tpu_torch.obs import metrics as t_metrics
from kata_xpu_device_plugin_tpu_torch.obs import profiler as t_profiler
from kata_xpu_device_plugin_tpu_torch.obs import trace as t_trace
from kata_xpu_device_plugin_tpu_torch.obs import watchdog as t_watchdog

SIDES = {"jax": (j_events, j_flight, j_trace, j_watchdog, j_devledger),
         "torch": (t_events, t_flight, t_trace, t_watchdog, t_devledger)}


def _without_ts(ev: dict) -> dict:
    return {k: v for k, v in ev.items() if k != "ts"}


@pytest.fixture
def sinks(tmp_path):
    """Each package's default sink swapped for one under ``tmp_path``."""
    out = {}
    for side, (events, *_rest) in SIDES.items():
        path = str(tmp_path / f"{side}.jsonl")
        s = events.EventSink(path)
        out[side] = (s, path, events.set_default_sink(s))
    yield {side: path for side, (_s, path, _p) in out.items()}
    for side, (s, _path, prev) in out.items():
        s.close()
        SIDES[side][0].set_default_sink(prev)


# ----- the sink and its readers ----------------------------------------------


EVENTS = [
    ("serving", "ttft", dict(rid=0, ttft_s=0.25, prompt_len=7, queued=3,
                             batched=2)),
    ("span", "serving.prefill", dict(trace="ab", span="cd", parent=None,
                                     dur_s=0.5, tokens=7, rids=[0, 1])),
    ("serving", "serving_heartbeat", dict(round=32, mfu=0.001,
                                          phase_admit_s=0.1, chips="")),
    ("span", "serving.decode_chunk", dict(dur_s=0.125, np_value=np.float32(1.5),
                                          np_int=np.int64(3))),
    ("span", "serving.prefill", dict(dur_s=0.25)),
]


def test_event_sink_lines_match(tmp_path):
    """The same events give the same JSONL lines (the clock fixed, so ``ts``
    too); numpy scalars encode alike, and the port also encodes tensors."""
    lines = {}
    for side, (events, *_rest) in SIDES.items():
        path = str(tmp_path / f"{side}.jsonl")
        with events.EventSink(path, clock=lambda: 1722700000.123) as sink:
            for kind, name, fields in EVENTS:
                sink.emit(kind, name, **fields)
            assert sink.emitted == len(EVENTS)
        lines[side] = open(path).read().splitlines()
    assert lines["torch"] == lines["jax"]
    with t_events.EventSink(str(tmp_path / "t.jsonl")) as sink:
        ev = sink.emit("span", "x", loss=torch.tensor(2.5), ids=torch.arange(2))
    assert json.loads(json.dumps(ev, default=t_events._jsonable))["loss"] == 2.5


def test_readers_match_across_rotation(tmp_path):
    """``read_events`` (with an offset and a torn tail), ``tail_events``
    through a truncation and ``summarize_phases`` read one file alike."""
    path = str(tmp_path / "ev.jsonl")
    with t_events.EventSink(path) as sink:
        for kind, name, fields in EVENTS:
            sink.emit(kind, name, **fields)
    half = os.path.getsize(path) // 2
    with open(path, "a") as fh:
        fh.write('{"kind": "span", "name": "torn"')  # a writer killed mid-line
    got = {}
    for side, (events, *_rest) in SIDES.items():
        first, off = events.tail_events(path, 0)
        again, off2 = events.tail_events(path, off)
        got[side] = [events.read_events(path), events.read_events(path, half),
                     first, off, again, off2,
                     events.summarize_phases(first),
                     events.summarize_phases(first, prefix="serving.")]
    assert got["torch"] == got["jax"]
    assert got["jax"][3] < os.path.getsize(path)  # the torn tail stays unread
    with open(path, "w") as fh:  # rotated: the stream restarts, shorter
        fh.write('{"kind": "serving", "name": "restart"}\n')
    after = {side: SIDES[side][0].tail_events(path, got[side][3])
             for side in SIDES}
    assert after["torch"] == after["jax"] == ([{"kind": "serving",
                                                "name": "restart"}], 39)
    assert t_events.tail_events(str(tmp_path / "missing"), 5) == ([], 0)


def test_emit_default_sink_and_env(sinks, monkeypatch, tmp_path):
    """``emit`` through the default sink, and the env switch and file names
    the daemon injects (``KATATPU_OBS``/``KATA_TPU_OBS``,
    ``KATATPU_OBS_FILE``)."""
    for side in SIDES:
        assert SIDES[side][0].emit("serving", "drain", reason="api",
                                   completed=2, failed=0) is not None
    got = {side: [_without_ts(e) for e in SIDES[side][0].read_events(path)]
           for side, path in sinks.items()}
    assert got["torch"] == got["jax"]
    for env in ("KATATPU_OBS", "KATA_TPU_OBS"):
        monkeypatch.setenv(env, "1")
        monkeypatch.setenv("KATATPU_OBS_FILE", str(tmp_path / "env.jsonl"))
        assert t_events.enabled() and j_events.enabled()
        assert t_events.events_path() == j_events.events_path()
        monkeypatch.delenv(env)
    assert not t_events.enabled()


# ----- the flight recorder ---------------------------------------------------


@pytest.mark.parametrize("case", ["terminal", "failed_drain", "capacity_env",
                                  "disarmed"])
def test_flight_ring_matches(case, monkeypatch, tmp_path):
    """The ring's capacity (argument and ``KATATPU_FLIGHT_RING``), the dump
    on a terminal event (a drain only when it failed requests), the dump's
    name and contents, and ``KATATPU_FLIGHT=0``, against the JAX ring."""
    monkeypatch.setenv("KATATPU_FLIGHT_DIR", str(tmp_path / "dumps"))
    out = {}
    for side, (_e, flight, *_r) in SIDES.items():
        if case == "capacity_env":
            monkeypatch.setenv("KATATPU_FLIGHT_RING", "3")
        if case == "disarmed":
            monkeypatch.setenv("KATATPU_FLIGHT", "0")
            out[side] = flight.configure_from_env(force=True)
            continue
        rec = (flight.configure_from_env(force=True) if case == "capacity_env"
               else flight.FlightRecorder(capacity=4))
        for i in range(6):
            rec.record({"kind": "serving", "name": "tick", "i": i})
        rec.record({"kind": "serving", "name": "drain", "failed": 0})
        if case == "terminal":
            rec.record({"kind": "serving", "name": "fatal_error", "error": "x"})
        elif case == "failed_drain":
            rec.record({"kind": "serving", "name": "drain", "failed": 2})
        dumps = [os.path.basename(d).rsplit("_", 2)[0] for d in rec.dumps]
        contents = [open(d).read() for d in rec.dumps]
        out[side] = (rec.capacity, rec.snapshot(), dumps, contents)
        flight.configure_from_env(force=True)
    assert out["torch"] == out["jax"]
    if case in ("terminal", "failed_drain"):
        assert len(out["jax"][2]) == 1
    elif case == "disarmed":
        assert out["jax"] is None
    else:
        assert out["jax"][0] == 3 and out["jax"][2] == []


# ----- metrics ---------------------------------------------------------------


def _families(text: str) -> dict:
    """``{family: (type, {(sample, labels): value})}``; the values of the
    ``_created`` timestamps are left out."""
    out = {}
    for fam in text_string_to_metric_families(text):
        samples = {(s.name, tuple(sorted(s.labels.items()))):
                   None if s.name.endswith("_created") else s.value
                   for s in fam.samples}
        out[fam.name] = (fam.type, samples)
    return out


def _populate(reg) -> None:
    c = reg.counter("kata_tpu_test_hits", "Hits", ["server"])
    c.labels(server="s0").inc()
    c.labels(server="s0").inc(2)
    c2 = reg.counter("kata_tpu_test_moves_total", "Moves", ["server"])
    c2.labels(server="s1").inc(5)
    g = reg.gauge("kata_tpu_test_occ", "Occupancy", ["server", "shard"])
    g.labels(server="s0", shard="0").set(0.25)
    g.labels(server="s0", shard="1").set_function(lambda: 0.5)
    reg.gauge("kata_tpu_test_nan", "Unknown", ["server"]).labels(
        server="s0").set_function(lambda: float("nan"))
    h = reg.histogram("kata_tpu_test_lat_seconds", "Latency", ["server"])
    for v in (0.0004, 0.003, 0.2, 7.0, 99.0):
        h.labels(server="s0").observe(v)
    plain = reg.gauge("kata_tpu_test_loss", "Loss")
    plain.set(1.5)
    reg.histogram("kata_tpu_test_step_seconds", "Steps").observe(0.02)


def test_metrics_exposition_matches_prometheus_client():
    """The plain-Python registry's text format parses, with
    ``prometheus_client``'s own parser, into the families, types, labels,
    bucket bounds and values of ``prometheus_client`` fed the same calls."""
    jreg = j_metrics.MetricsRegistry(CollectorRegistry())
    _populate(jreg)
    treg = t_metrics.MetricsRegistry()
    _populate(treg)
    want = _families(generate_latest(jreg.registry).decode())
    got = _families(treg.exposition())
    assert set(got) == set(want)
    for name, (kind, samples) in want.items():
        assert got[name][0] == kind, name
        assert set(got[name][1]) == set(samples), name
        for key, v in samples.items():
            w = got[name][1][key]
            assert w == v or (np.isnan(v) and np.isnan(w)), (name, key)


def test_metrics_registry_idempotent_and_served():
    """Creation is idempotent, a type or label clash raises, and the
    ``/metrics`` handler answers with the exposition (driven here without a
    socket: tests reach no network)."""
    import io

    reg = t_metrics.MetricsRegistry()
    c = reg.counter("kata_tpu_x_total", "X", ["server"])
    assert reg.counter("kata_tpu_x", "X", ["server"]) is c
    with pytest.raises(ValueError, match="already exists"):
        reg.gauge("kata_tpu_x", "X", ["server"])
    with pytest.raises(ValueError, match="already exists"):
        reg.counter("kata_tpu_x", "X", ["shard"])
    with pytest.raises(ValueError):
        c.inc()  # a labelled collector counts through a child
    c.labels(server="a").inc()
    assert t_metrics.serve(0, reg) is None  # port 0: no endpoint
    replies = {}
    for path in ("/metrics", "/other"):
        cls = t_metrics._handler(reg)
        h = cls.__new__(cls)
        h.path, h.command, h.request_version = path, "GET", "HTTP/1.1"
        h.requestline, h.client_address = f"GET {path} HTTP/1.1", ("", 0)
        h.wfile = io.BytesIO()
        h.do_GET()
        replies[path] = h.wfile.getvalue().decode()
    head, _, body = replies["/metrics"].partition("\r\n\r\n")
    assert " 200 " in head.splitlines()[0] and t_metrics.CONTENT_TYPE in head
    assert body == reg.exposition()
    assert 'kata_tpu_x_total{server="a"} 1.0' in body
    assert " 404 " in replies["/other"].splitlines()[0]


# ----- spans -----------------------------------------------------------------


def _span_script(trace_mod, events_mod):
    with trace_mod.span("outer", step=1) as o:
        assert trace_mod.current_span_id() == o.span_id
        with trace_mod.span("inner", tokens=64) as i:
            assert i.parent_id == o.span_id and i.trace_id == o.trace_id
        det = trace_mod.start_span("detached", trace_id="feedbeef",
                                   chunk_tokens=8)
        with trace_mod.span("while_detached"):
            assert trace_mod.current_span().name == "while_detached"
        det.mark("dispatch")
        det.set(round_s=0.5).end()
    with pytest.raises(ValueError):
        with trace_mod.span("raises"):
            raise ValueError("boom")

    @trace_mod.traced("decorated")
    def f(x):
        return x

    f(3)
    with trace_mod.timer("timed", metric=t_metrics.Rolling()):
        pass
    assert trace_mod.current_span() is None


def test_span_tree_matches(sinks):
    """Nesting, ids, a detached span (not the ambient parent, pinned to a
    trace), ``mark``, errors, ``traced`` and ``timer``: the same events,
    fields and tree, times and ids aside; ``tokens_per_s`` derived."""
    trees = {}
    for side, path in sinks.items():
        _e, _f, trace_mod, *_r = SIDES[side]
        _span_script(trace_mod, SIDES[side][0])
        evs = SIDES[side][0].read_events(path)
        names = {e["span"]: e["name"] for e in evs}
        trees[side] = [
            (e["kind"], e["name"], names.get(e["parent"]),
             e["trace"] == "feedbeef",
             sorted(k for k in e if k not in ("ts",)),
             {k: v for k, v in e.items()
              if k in ("step", "tokens", "chunk_tokens", "round_s", "error")})
            for e in evs]
    assert trees["torch"] == trees["jax"]
    inner = next(t for t in trees["jax"] if t[1] == "inner")
    assert "tokens_per_s" in inner[4]


def test_span_fence_on_cpu_and_device_fence():
    """A CPU tensor needs no fence; ``DeviceFence`` hands back host copies
    that later writes cannot reach."""
    t = torch.arange(4, dtype=torch.int32)
    with t_trace.span("cpu") as sp:
        sp.fence([t, {"x": t}])
    assert sp.duration_s >= 0
    fence = t_trace.DeviceFence(toks=t)
    t.fill_(7)
    np.testing.assert_array_equal(fence.wait()["toks"], [0, 1, 2, 3])


# ----- the watchdog ----------------------------------------------------------


def _hb(**kw):
    base = dict(round=1, interval_rounds=4, interval_s=1.0, tokens_per_s=100.0,
                itl_p99_ms=10.0, preemptions_delta=0, recoveries_delta=0,
                prefix_hits_delta=0, prefix_misses_delta=0, kv_host_tokens=0)
    base.update(kw)
    return base


# The heartbeat sequences of the JAX suite's watchdog tests
# (tests/test_watchdog.py, tests/test_devledger.py), with their configs.
SCENARIOS = {
    "slo_burn": (dict(slo_ms=50.0, window=2, sustain=2, clear=2),
                 [_hb(itl_p99_ms=120.0)] * 4 + [_hb(itl_p99_ms=5.0)] * 3),
    "anomalies": (dict(slo_ms=0.0, sustain=1, clear=1, preempt_storm=4,
                       recovery_storm=2, hit_floor=0.5, min_lookups=4),
                  [_hb(preemptions_delta=4), _hb(recoveries_delta=2),
                   _hb(prefix_hits_delta=1, prefix_misses_delta=9),
                   _hb(prefix_hits_delta=1, prefix_misses_delta=9,
                       kv_host_tokens=1024), _hb()]),
    "tokens_regression": (dict(slo_ms=0.0, sustain=1, clear=1, min_samples=3,
                               regress_ratio=0.5),
                          [_hb(tokens_per_s=100.0)] * 4
                          + [_hb(tokens_per_s=30.0), _hb(tokens_per_s=100.0),
                             _hb(tokens_per_s=30.0),
                             _hb(tokens_per_s=0.0, interval_rounds=0)]),
    "device_idle": (dict(slo_ms=1000.0, sustain=2, clear=2, min_samples=2,
                         gap_ratio=3.0, gap_min_ms=1.0),
                    [_hb(dispatch_gap_ms=2.0, dispatches_delta=4)] * 2
                    + [_hb(dispatch_gap_ms=50.0, dispatches_delta=4)] * 3
                    + [_hb(dispatch_gap_ms=2.0, dispatches_delta=4)] * 2),
    "device_idle_disarmed": (dict(slo_ms=1000.0, sustain=1, min_samples=1,
                                  gap_ratio=2.0, gap_min_ms=0.5),
                             [_hb(dispatch_gap_ms=1.0, dispatches_delta=2),
                              _hb(),
                              _hb(dispatch_gap_ms=500.0, dispatches_delta=0),
                              _hb(dispatch_gap_ms=0.4, dispatches_delta=2)]),
    "hbm_headroom": (dict(slo_ms=1000.0, sustain=2, clear=1,
                          headroom_floor_frac=0.1),
                     [_hb(hbm_headroom_bytes=50, hbm_peak_bytes=1000)] * 2
                     + [_hb(hbm_headroom_bytes=500, hbm_peak_bytes=1000),
                        _hb(hbm_headroom_bytes=0, hbm_peak_bytes=0)]),
    "garbage": (dict(slo_ms=50.0, sustain=1),
                [{"itl_p99_ms": "garbage", "interval_rounds": "x"}, {}]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_watchdog_scenarios_match(name):
    """The same alerts, clears and dump reasons, heartbeat by heartbeat, and
    the same ``stats()``."""
    cfg_kw, beats = SCENARIOS[name]
    runs = {}
    for side, (*_x, watchdog, _d) in SIDES.items():
        evs, dumps = [], []
        wd = watchdog.SLOBurnWatchdog(
            watchdog.WatchdogConfig(**cfg_kw),
            emit=lambda n, evs=evs, **f: evs.append({"name": n, **f}),
            dump=lambda reason, dumps=dumps: dumps.append(reason) or reason)
        fired = [wd.observe(dict(hb)) for hb in beats]
        runs[side] = (fired, evs, dumps, wd.active, wd.stats())
    assert runs["torch"] == runs["jax"]
    if name not in ("garbage", "device_idle_disarmed"):
        assert any(runs["jax"][0])


def test_watchdog_flight_dump_and_env(monkeypatch, tmp_path):
    """The default dump goes through each package's flight ring, named
    ``watchdog_<kind>``; ``WatchdogConfig.from_env`` degrades malformed
    knobs alike; ``KATA_TPU_WATCHDOG=0`` disarms."""
    monkeypatch.setenv("KATATPU_FLIGHT_DIR", str(tmp_path))
    names = {}
    for side, (_e, flight, _t, watchdog, _d) in SIDES.items():
        rec = flight.FlightRecorder(capacity=8)
        prev = flight.set_default_recorder(rec)
        try:
            rec.record({"kind": "serving", "name": "warmup"})
            evs = []
            wd = watchdog.SLOBurnWatchdog(
                watchdog.WatchdogConfig(slo_ms=0.0, sustain=1, preempt_storm=1),
                emit=lambda n, evs=evs, **f: evs.append({"name": n, **f}))
            assert wd.observe(_hb(preemptions_delta=1)) == ["preempt_storm"]
            dump = evs[0]["dump"]
            names[side] = (os.path.basename(dump).rsplit("_", 2)[0],
                           open(dump).read(), wd.stats()["last_dump"] == dump)
        finally:
            flight.set_default_recorder(prev)
    assert names["torch"] == names["jax"]
    monkeypatch.setenv("KATA_TPU_WATCHDOG_WINDOW", "not-a-number")
    monkeypatch.setenv("KATA_TPU_WATCHDOG_BURN", "0.9")
    monkeypatch.setenv("KATA_TPU_ITL_SLO_MS", "12")
    for slo in (None, 25.0):
        assert (t_watchdog.WatchdogConfig.from_env(slo_ms=slo).as_fields()
                == j_watchdog.WatchdogConfig.from_env(slo_ms=slo).as_fields())
    monkeypatch.setenv("KATA_TPU_WATCHDOG", "0")
    assert not t_watchdog.enabled() and not j_watchdog.enabled()
    assert t_watchdog.ALERT_KINDS == j_watchdog.ALERT_KINDS


# ----- the device ledger over a scripted clock -------------------------------


class _Clock:
    """A phase clock whose snapshots follow a script."""

    def __init__(self, snaps):
        self._snaps = iter(snaps)

    def snapshot(self):
        return dict(next(self._snaps))


class _JaxCost:
    """A jitted-function stand-in whose lowering reports ``flops``."""

    def __init__(self, flops):
        self.flops = flops

    def lower(self, *a, **k):
        flops = self.flops

        class _L:
            def cost_analysis(self):
                return {"flops": flops, "bytes accessed": 8.0}

            def compile(self):
                raise RuntimeError("no compile in a unit test")

        return _L()


class _NoStats:
    platform = "cpu"
    device_kind = "cpu"

    def memory_stats(self):
        return None


# (perf_counter stamps, clock snapshots, [(op, key, flops, loop_cap,
# delivered)]): dispatches and retires of lock-step, overlapped and
# persistent rounds with host work between them.
LEDGER_SCRIPTS = {
    "lockstep_gaps": (
        [0.0, 1.0, 1.5, 2.5, 3.2, 4.0],
        [{"admit": 0.0, "retire": 0.0}, {"admit": 0.3, "retire": 0.1},
         {"admit": 0.3, "retire": 0.2}, {"admit": 0.9, "retire": 0.6},
         {"admit": 0.9, "retire": 0.6}],
        [("d", "a", 2e12, None, None), ("r",), ("d", "a", 2e12, None, None),
         ("r",), ("d", "b", 1e12, None, None), ("r",)]),
    "overlapped": (
        [0.0, 0.1, 1.0, 1.1, 2.0, 3.0],
        [{}, {"dispatch": 0.05}, {"dispatch": 0.05}, {"dispatch": 0.2},
         {"dispatch": 0.2}, {"dispatch": 0.3}],
        [("d", "a", 3e12, None, None), ("d", "a", 3e12, None, None), ("r",),
         ("d", "a", 3e12, None, None), ("r",), ("r",)]),
    "persistent": (
        [0.0, 2.0, 2.5, 4.0],
        [{}, {"host_transfer": 0.2}, {"host_transfer": 0.2}],
        [("d", "p", 8e12, 256, None), ("r", 64), ("d", "p", 8e12, 256, None),
         ("r", 300)]),
    "cost_unavailable": (
        [0.0, 1.0, 2.0, 3.0],
        [{}, {}, {}],
        [("d", "z", 0.0, None, None), ("r",), ("d", "z", 0.0, None, None),
         ("r",)]),
}


@pytest.mark.parametrize("name", sorted(LEDGER_SCRIPTS))
def test_ledger_scripted_clock_matches(name, monkeypatch):
    """Gap attribution (rescaled to the gap, residual ``other``), busy
    fraction (overlapped windows counted once), persistent FLOPs by
    delivered steps, a signature without cost: the same heartbeat fields
    and stats from both ledgers. The port costs a signature analytically
    (a callable), JAX by lowering; both are handed the same FLOPs."""
    stamps, snaps, ops = LEDGER_SCRIPTS[name]
    phases = ("admit", "dispatch", "retire", "host_transfer", "other")
    out = {}
    for side, (*_x, devledger) in SIDES.items():
        clock_it = iter(stamps)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock_it))
        evs = []
        kw = dict(armed=True, clock=_Clock(snaps), gap_phases=phases,
                  emit=lambda n, evs=evs, **f: evs.append({"name": n, **f}))
        if side == "jax":
            led = devledger.DeviceLedger(device=_NoStats(), **kw)
        else:
            led = devledger.DeviceLedger(device="cpu", **kw)
        for op in ops:
            if op[0] == "d":
                _d, key, flops, cap, _ = op
                if side == "jax":
                    led.on_dispatch((key,), _JaxCost(flops), (), {}, loop_cap=cap)
                else:
                    led.on_dispatch((key,), lambda f=flops: {
                        "flops": f, "bytes_accessed": 8.0}, loop_cap=cap)
            else:
                led.note_retire(delivered_steps=op[1] if len(op) > 1 else None)
        monkeypatch.undo()
        fields = led.heartbeat_fields(interval_s=stamps[-1])
        st = led.stats_fields()
        st["devledger"].pop("peak_flops")  # a TPU table's and a card's
        out[side] = (fields, st, [{k: v for k, v in e.items() if k != "signature"}
                                  for e in evs])
    assert out["torch"] == out["jax"]
    f = out["jax"][0]
    assert 0 < f["device_busy_frac"] <= 1 or name == "cost_unavailable"
    gap_parts = sum(f[f"dispatch_gap_{p}_ms"] for p in phases)
    assert abs(gap_parts - f["dispatch_gap_ms"]) <= 1e-3 * len(phases)


def test_ledger_cpu_memory_and_peak():
    """On the CPU the ``hbm_*`` fields are omitted with one
    ``hbm_stats_unavailable``; the peak is the named placeholder; a failing
    cost callable degrades once per signature; disarmed, nothing moves."""
    evs = []
    led = t_devledger.DeviceLedger(
        device="cpu", emit=lambda n, **f: evs.append({"name": n, **f}))
    assert led.poll_memory() == {} and led.poll_memory() == {}
    assert [e["name"] for e in evs] == ["hbm_stats_unavailable"]
    assert evs[0]["platform"] == "cpu"
    assert led.peak_flops() == t_devledger.CPU_PLACEHOLDER_FLOPS
    led.on_dispatch(("k",), lambda: 1 / 0)
    led.on_dispatch(("k",), lambda: 1 / 0)
    assert [e["reason"] for e in evs if e["name"] == "cost_unavailable"] == [
        "cost_failed:ZeroDivisionError"]
    off = t_devledger.DeviceLedger(armed=False, device="cpu")
    off.on_dispatch(("k",), lambda: {"flops": 1.0})
    off.note_retire()
    assert off.heartbeat_fields(1.0) == {} and off.stats_fields()["mfu"] == 0.0


# ----- profiler, strict mode, the tripwire -----------------------------------


def test_profiler_window_writes_a_trace(sinks, tmp_path):
    """A ``torch.profiler`` window over steps 2-3 writes a Chrome trace and
    emits ``profile``/``torch_trace``; a second hook meanwhile degrades to
    ``profiler_busy``; ``profiler_from_env`` reads the JAX names."""
    hook = t_profiler.ProfilerHook(str(tmp_path / "prof"), start_step=2,
                                   num_steps=2)
    other = t_profiler.ProfilerHook(str(tmp_path / "other"), start_step=3)
    for step in range(0, 5):
        hook.on_step(step)
        other.on_step(step)
        torch.ones(8).sum()
    hook.close()
    other.close()
    assert hook.trace_path and os.path.getsize(hook.trace_path) > 0
    evs = t_events.read_events(sinks["torch"])
    assert [e["name"] for e in evs] == ["profiler_busy", "torch_trace"]
    assert evs[1]["start_step"] == 2 and evs[1]["stop_step"] == 3
    os.environ["KATATPU_OBS_PROFILE_DIR"] = str(tmp_path)
    try:
        assert t_profiler.profiler_from_env().stop_after == 4
    finally:
        del os.environ["KATATPU_OBS_PROFILE_DIR"]


def test_strict_mode_on_the_cpu_is_bookkeeping(monkeypatch):
    """``KATA_TPU_STRICT`` reads as in JAX; on the CPU strict mode nests,
    counts and guards nothing (a host read inside raises nothing)."""
    from kata_xpu_device_plugin_tpu.compat import jaxapi

    for raw in ("1", "true", "on", "0", "", "no"):
        env = {"KATA_TPU_STRICT": raw}
        assert torchapi.strict_enabled(env) == jaxapi.strict_enabled(env)
    with torchapi.strict_mode(scope="t", device="cpu"):
        with torchapi.strict_mode(scope="t2"):
            assert torchapi.strict_depth() == 2
            with torchapi.allow_transfer("sanctioned"):
                assert torch.ones(2).sum().item() == 2.0
        assert torch.ones(1).item() == 1.0
    assert torchapi.strict_depth() == 0


def test_compile_tripwire_counts():
    """Compiles noted in the scope and tensors that moved count; disabled,
    the counts stay zero (``TripwireCounts`` as JAX's)."""
    t = {"w": torch.zeros(4)}
    with torchapi.compile_tripwire(
            addresses=lambda: {"w": t["w"].data_ptr()}) as tw:
        torchapi.note_compile("decode signature")
        t["w"] = torch.zeros(4)
    assert (tw.compiles, tw.transfers, tw.armed) == (1, 1, True)
    with torchapi.compile_tripwire(enabled=False) as off:
        torchapi.note_compile()
    assert (off.compiles, off.transfers, off.armed) == (0, 0, False)
