"""PyTorch port, crash tolerance: the port's ``guest/resilience.py`` against
the JAX module, and the port's supervised ``GenerationServer`` against the
JAX server under the same fault schedules (fp32, the CPU, equal weights
and prompts). For each schedule both servers give the same results, the
same failures with the same errors, the same fired faults, the same
resilience counters and the same order of ``recovery``, ``checkpoint``
and ``request_failed`` events; within the port, the recovered tokens
equal a fault-free run's. The mesh shrink is ``test_torch_degraded.py``'s.
"""
from __future__ import annotations

from dataclasses import replace

import os
import signal
import threading
import time

import pytest
import torch

from kata_xpu_device_plugin_tpu import obs as jobs
from kata_xpu_device_plugin_tpu.guest import resilience as jres
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu_torch import obs as tobs
from kata_xpu_device_plugin_tpu_torch.guest import resilience as tres
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer

from .torch_faults import (
    CHAOS,
    PAGED,
    SIDES,
    injector,
    make_prompts,
    read_events,
    make_server,
    assert_same,
    clean_port,
    serve_both,
)
from .torch_parity import CONFIGS, build_pair


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tiny servers gain nothing from more, and
    beside other test processes lose their time to threads waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """One layer: the outcomes do not depend on depth, and the JAX
    servers' compiles, most of these tests' time, shrink with it."""
    jcfg = replace(CONFIGS["tiny"](), n_layers=1)
    return (jcfg,) + build_pair(jcfg, seed=0)



# ----- the module against the JAX module --------------------------------------

GRAMMAR = [
    "decode_dispatch:3", "fence:0:hang", "prefill:2:raise-oom",
    "pool_alloc:1:raise-transient", "decode_dispatch:3:chip_loss:1",
    "fence:0:ici_error", "prefill:2:chip_loss", "sched_tick:4,store_gather:0",
    "bogus:1", "fence:x", "fence:-1", "fence:0:explode", "fence:0:ici_error:1",
    "decode_dispatch:1:chip_loss:x", "decode_dispatch:1:chip_loss:-2",
    "a:b:c:d:e", " , decode_dispatch:0 ,, admission_commit:2:hang", "",
]


@pytest.mark.parametrize("raw", GRAMMAR)
def test_parse_schedule_matches_jax(raw):
    want_specs, want_bad = jres.parse_schedule(raw)
    got_specs, got_bad = tres.parse_schedule(raw)
    assert [tuple(vars(s).values()) for s in got_specs] == [
        tuple(vars(s).values()) for s in want_specs]
    assert got_bad == want_bad
    assert tres.SEAMS == jres.SEAMS and tres.KINDS == jres.KINDS
    assert tres.PERMANENT_KINDS == jres.PERMANENT_KINDS


def test_same_seed_same_sequence():
    """Two injectors of one seed and schedule fire the same faults at the
    same crossings, the JAX injector's, and draw the same hang jitter."""
    raw = "prefill:1,fence:0:hang,decode_dispatch:2:chip_loss:3,fence:2:ici_error"
    seams = ["prefill", "fence", "decode_dispatch"] * 4
    fired = {}
    for name, mod in (("jax", jres), ("torch", tres), ("torch2", tres)):
        inj = mod.FaultInjector(mod.parse_schedule(raw)[0], seed=7)
        kinds = []
        for seam in seams:
            try:
                inj.fire(seam)
            except Exception as e:  # noqa: BLE001 — each fault's type
                kinds.append((seam, type(e).__name__,
                              getattr(e, "device_index", None)))
        fired[name] = (inj.fired, kinds, inj._rng.random(), inj.armed)
    assert fired["torch"] == fired["jax"] == fired["torch2"]
    assert fired["torch"][3] is False and len(fired["torch"][0]) == 4


def test_fence_with_timeout(tmp_path):
    """Inline without a deadline; on a pooled worker with one, relaying
    values and errors; a wait past the deadline raises
    ``DeviceStallError`` after a ``device_stall`` event, as JAX's; an
    injected hang stalls at once."""
    assert tres.fence_with_timeout(lambda: threading.current_thread()) is (
        threading.current_thread())
    worker = tres.fence_with_timeout(lambda: threading.current_thread(),
                                     timeout_s=5.0)
    assert worker is not threading.current_thread()
    assert tres.fence_with_timeout(lambda: threading.current_thread(),
                                   timeout_s=5.0) is worker  # pooled
    with pytest.raises(KeyError):
        tres.fence_with_timeout(lambda: {}["x"], timeout_s=5.0)
    events = {}
    for name, mod, pkg in (("jax", jres, jobs), ("torch", tres, tobs)):
        path = str(tmp_path / f"{name}.jsonl")
        sink = pkg.EventSink(path)
        prev = pkg.set_default_sink(sink)
        try:
            with pytest.raises(mod.DeviceStallError):
                mod.fence_with_timeout(lambda: time.sleep(0.3), timeout_s=0.05,
                                       server="s", trace="t")
            inj = mod.FaultInjector([mod.FaultSpec("fence", 0, "hang")])
            t0 = time.perf_counter()
            with pytest.raises(mod.DeviceStallError):
                mod.fence_with_timeout(lambda: time.sleep(5), timeout_s=60,
                                       injector=inj)
            assert time.perf_counter() - t0 < 1.0
        finally:
            pkg.set_default_sink(prev)
            sink.close()
        events[name] = [{k: v for k, v in e.items() if k not in ("ts",)}
                        for e in read_events(pkg, path)]
    assert events["torch"] == events["jax"]
    assert [e["name"] for e in events["torch"]] == [
        "device_stall", "fault_injected", "device_stall"]


@pytest.mark.parametrize("raw", ["", "12", "2.5", "soon"])
def test_env_knobs_degrade_like_jax(raw, monkeypatch, tmp_path):
    monkeypatch.setenv("KATA_TPU_TEST_KNOB", raw)
    got = {}
    for name, mod, pkg in (("jax", jres, jobs), ("torch", tres, tobs)):
        path = str(tmp_path / f"{name}.jsonl")
        sink = pkg.EventSink(path)
        prev = pkg.set_default_sink(sink)
        try:
            vals = (mod.env_int("KATA_TPU_TEST_KNOB", 3, event="knob_invalid",
                                server="s", trace="t"),
                    mod.env_float("KATA_TPU_TEST_KNOB", 0.5,
                                  event="knob_invalid", server="s"))
        finally:
            pkg.set_default_sink(prev)
            sink.close()
        got[name] = (vals, [(e["name"], e["reason"], e.get("trace"))
                            for e in read_events(pkg, path)])
    assert got["torch"] == got["jax"]


# The triage of CUDA errors (the module doc's table).
CUDA_ERRORS = [
    ("CUDA error: out of memory", tres.TRANSIENT),
    ("CUDA error: uncorrectable ECC error encountered", tres.PERMANENT),
    ("CUDA error: uncorrectable NVLink error detected during the execution",
     tres.PERMANENT),
    ("CUDA error: CUDA-capable device(s) is/are busy or unavailable",
     tres.PERMANENT),
    ("CUDA error: no CUDA-capable device is detected", tres.PERMANENT),
    ("CUDA error: unspecified launch failure", tres.PERMANENT),
    ("CUDA error: an illegal memory access was encountered", None),
    ("CUDA error: an illegal instruction was encountered", None),
    ("CUDA error: misaligned address", None),
    ("CUDA error: device-side assert triggered", None),
    ("CUDA error: invalid argument", None),
    ("CUDA error: too many resources requested for launch", None),
    ("paged_decode kernel launch failed: cudaError 700", None),
    ("host allocator: out of memory", None),
]


@pytest.mark.parametrize("msg,verdict", CUDA_ERRORS)
def test_classify_cuda_errors(msg, verdict):
    classes = [RuntimeError]
    if hasattr(torch, "AcceleratorError"):
        classes.append(torch.AcceleratorError)
    for cls in classes:
        try:
            exc = cls(msg)
        except TypeError:  # a class that wants more than the message
            continue
        assert tres.classify(exc) == verdict, (cls, msg)
        assert tres.recoverable(exc) is (verdict is not None)
    assert tres.classify(ValueError(msg)) is None


def test_classify_injected_kinds_and_oom():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    assert tres.classify(oom) == tres.TRANSIENT
    for exc, verdict in ((tres.TransientFault("x"), tres.TRANSIENT),
                         (tres.InjectedOom("x"), tres.TRANSIENT),
                         (tres.DeviceStallError("x"), tres.TRANSIENT),
                         (tres.ChipLossFault("x", 1), tres.PERMANENT),
                         (tres.IciFault("x"), tres.PERMANENT),
                         (AssertionError(), None)):
        assert tres.classify(exc) == verdict
    assert "RESOURCE_EXHAUSTED" in str(pytest.raises(
        tres.InjectedOom, injector("torch", [("fence", 0, "raise-oom")]).fire,
        "fence").value)


# ----- the server under schedules ---------------------------------------------


@pytest.mark.parametrize("overlap", [False, True], ids=["lockstep", "overlap"])
@pytest.mark.parametrize("paged", [False, True], ids=["slotted", "paged"])
def test_chaos_schedule_matches_jax(models, tmp_path, paged, overlap):
    """The JAX recovery tests' chaos schedule: the same outcome as the JAX
    server, and tokens equal to the port's fault-free run."""
    kw = dict(overlap=overlap, checkpoint_rounds=2, **(PAGED if paged else {}))
    got = assert_same(serve_both(models, tmp_path, schedule=CHAOS, seed=3, **kw))
    assert got["results"] == clean_port(models, overlap=overlap,
                                        **(PAGED if paged else {}))
    assert got["stats"]["recoveries"] == (4 if paged else 3)
    assert got["stats"]["device_stalls"] == 1 and got["failures"] == {}


def test_checkpoint_restore_bounds_the_replay(models, tmp_path):
    got = assert_same(serve_both(
        models, tmp_path, lengths=(4, 6), budgets=12,
        schedule=[("decode_dispatch", 2)], checkpoint_rounds=1, overlap=False))
    (rec,) = [f for n, f in got["events"] if n == "recovery"]
    assert (rec["restored"], rec["requeued"]) == (2, 0)
    assert got["results"] == clean_port(models, lengths=(4, 6), budgets=12)


def test_quarantine_after_k(models, tmp_path):
    got = assert_same(serve_both(
        models, tmp_path, lengths=(4, 5), budgets=[6, 8],
        schedule=[("prefill", i) for i in range(3)], quarantine_after=3))
    assert list(got["failures"]) == [0] and got["stats"]["quarantined"] == 1
    assert [f["reason"] for n, f in got["events"] if n == "request_failed"] == [
        "quarantined"]


def test_reservation_fault_blames_the_culprit(models, tmp_path):
    """A fault reserving the queue head's blocks blames it alone: it
    quarantines after two strikes, the lane residents finish."""
    def patch(srv):
        orig, count = srv._reserve_lane_blocks, [0]

        def flaky(req, hit=None):
            if req.rid == 2 and count[0] < 2:
                count[0] += 1
                raise (jres if isinstance(srv, JaxServer) else tres).TransientFault(
                    "reservation died")
            return orig(req, hit)

        srv._reserve_lane_blocks = flaky

    got = assert_same(serve_both(models, tmp_path, lengths=(4, 5, 6),
                                 patch=patch, quarantine_after=2, **PAGED))
    assert list(got["failures"]) == [2]


def test_drain_under_a_fault(models, tmp_path):
    """A fault during a drain: started work replays and finishes, the
    never-started tail fails as drained, with the final checkpoint event."""
    def drive(srv):
        srv.step()
        srv.step()
        srv.request_drain(reason="test")
        return srv.run()

    got = assert_same(serve_both(models, tmp_path, lengths=(4, 5, 6, 7),
                                 budgets=16, schedule=[("decode_dispatch", 2)],
                                 drive=drive, overlap=False))
    assert sorted(got["results"]) == [0, 1]
    assert all(v.startswith("drained") for v in got["failures"].values())
    assert ("checkpoint", {"round": got["events"][-1][1]["round"], "lanes": 0,
                           "tokens": 0, "final": True}) in got["events"]


def test_recovery_kill_switch_unwinds(models, monkeypatch, tmp_path):
    monkeypatch.setenv("KATA_TPU_RECOVERY", "0")
    for side in ("jax", "torch"):
        srv = make_server(models, side, [("decode_dispatch", 0)])
        srv.submit(make_prompts(models[0].vocab_size, [4])[0], 4)
        with pytest.raises(SIDES[side][1].TransientFault):
            srv.run()


def test_non_recoverable_error_propagates(models, tmp_path):
    """A user bug raised inside a round propagates after a ``fatal_error``
    event; it is not recovered."""
    path = str(tmp_path / "ev.jsonl")
    sink = tobs.EventSink(path)
    prev = tobs.set_default_sink(sink)
    try:
        srv = make_server(models, "torch")

        def boom(seam):
            if seam == "prefill":
                raise ValueError("user bug")

        srv._inj.fire = boom
        srv.submit(make_prompts(models[0].vocab_size, [4])[0], 4)
        with pytest.raises(ValueError, match="user bug"):
            srv.run()
    finally:
        tobs.set_default_sink(prev)
        sink.close()
    (fatal,) = [e for e in read_events(tobs, path) if e["name"] == "fatal_error"]
    assert fatal["error"] == "ValueError: user bug"
    assert srv.stats()["recoveries"] == 0


def _real_permanent(srv, at: int = 2):
    """Make the ``at``-th decode dispatch raise a real PERMANENT CUDA error."""
    count = [0]
    fire = srv._inj.fire

    def fire_or_die(seam):
        if seam == "decode_dispatch":
            count[0] += 1
            if count[0] > at:
                raise RuntimeError(
                    "CUDA error: uncorrectable ECC error encountered")
        fire(seam)

    srv._inj.fire = fire_or_die


@pytest.mark.parametrize("dead_context", [False, True],
                         ids=["reset_works", "reset_raises"])
def test_real_permanent_error_fails_the_load(models, tmp_path, dead_context):
    """A real PERMANENT CUDA error takes the one card: ``chip_loss_fatal``
    with ``why="single_chip"``, every unfinished rid in ``failures()``
    (``chip_lost``) and none vanish. When the reset then raises too (the
    card's context is gone), the rids are failed before it, and its error
    propagates after a ``fatal_error`` event."""
    path = str(tmp_path / "ev.jsonl")
    sink = tobs.EventSink(path)
    prev = tobs.set_default_sink(sink)
    try:
        srv = make_server(models, "torch", tp=2, kv_layout="blocks", **PAGED)
        _real_permanent(srv)
        if dead_context:
            def dead(shards=None):  # the device part of the reset
                raise RuntimeError("CUDA error: unspecified launch failure")

            srv.kv_pool.reset = dead
        rids = [srv.submit(p, 8) for p in make_prompts(models[0].vocab_size,
                                                   (4, 8, 6, 3))]
        if dead_context:
            with pytest.raises(RuntimeError, match="unspecified launch"):
                srv.run()
        res = srv.run()  # the results banked before the fault
    finally:
        tobs.set_default_sink(prev)
        sink.close()
    fails = srv.failures()
    assert set(res) | set(fails) == set(rids) and not set(res) & set(fails)
    assert fails and all("uncorrectable ECC" in v for v in fails.values())
    names = [e["name"] for e in read_events(tobs, path)]
    evs = {e["name"]: e for e in read_events(tobs, path)}
    assert evs["chip_loss_fatal"]["why"] == "single_chip"
    assert evs["chip_loss_fatal"]["reason"] == "cuda_error"
    first_fail = names.index("request_failed")
    assert names.index("chip_loss_fatal") < first_fail
    if dead_context:
        assert names[-1] == "fatal_error" or "fatal_error" in names[first_fail:]
    assert srv.stats()["tp_degree"] == 2  # no shrink onto a dead card


def test_transient_cuda_oom_recovers(models):
    """A real CUDA out-of-memory error in a round is TRANSIENT: the server
    recovers and its tokens equal the fault-free run's."""
    srv = make_server(models, "torch", **PAGED)
    fire, count = srv._inj.fire, [0]

    def oom(seam):
        if seam == "pool_alloc":
            count[0] += 1
            if count[0] == 3:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        fire(seam)

    srv._inj.fire = oom
    prompts = make_prompts(models[0].vocab_size, (4, 8, 6, 3))
    rids = [srv.submit(p, 8) for p in prompts]
    res = srv.run()
    assert {r: res[r].tolist() for r in rids} == clean_port(models, **PAGED)
    assert srv.stats()["recoveries"] == 1


def test_wire_drain_maintenance_file_and_sigterm(models, tmp_path):
    """The port's server drains on the maintenance notice and on SIGTERM,
    chaining the prior handler."""
    srv = make_server(models, "torch")
    notice = tmp_path / "maintenance"
    wiring = tres.wire_drain(srv, sigterm=False, maintenance_file=str(notice),
                             poll_s=0.01)
    try:
        assert wiring.poll_once() is False and not srv.stats()["draining"]
        notice.write_text("scheduled")
        assert wiring.poll_once() is True and srv.stats()["draining"]
    finally:
        wiring.stop()
    srv2 = make_server(models, "torch")
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda *a: seen.append(a))
    try:
        with tres.wire_drain(srv2, sigterm=True):
            os.kill(os.getpid(), signal.SIGTERM)
            assert srv2.stats()["draining"] and seen
        assert signal.getsignal(signal.SIGTERM) is not None
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert srv2._drain_reason == "sigterm"


def test_env_schedule_drives_the_default_injector(models, monkeypatch):
    monkeypatch.setenv("KATA_TPU_FAULTS", "decode_dispatch:1,fence:0:hang,bad:1")
    monkeypatch.setenv("KATA_TPU_FAULTS_SEED", "11")
    jcfg, jp, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, device="cpu", max_batch=2, max_len=32,
                           chunk=4, recovery_backoff_s=0.0)
    assert srv._inj.armed and srv._inj.seed == 11
    prompts = make_prompts(jcfg.vocab_size, (4, 6))
    rids = [srv.submit(p, 8) for p in prompts]
    res = srv.run()
    assert {r: res[r].tolist() for r in rids} == clean_port(
        models, lengths=(4, 6))
    assert srv.stats()["recoveries"] == 2


def test_checkpoint_knob_rules(models, monkeypatch):
    """Explicit ``checkpoint_rounds`` with speculation raises as in JAX;
    a malformed env cadence degrades to 0."""
    jcfg, jp, tp, tcfg = models
    with pytest.raises(ValueError, match="speculative"):
        GenerationServer(tp, tcfg, device="cpu", speculative_k=2,
                         checkpoint_rounds=2)
    monkeypatch.setenv("KATA_TPU_CHECKPOINT_ROUNDS", "every-so-often")
    assert make_server(models, "torch").stats()["checkpoint_rounds"] == 0
    monkeypatch.setenv("KATA_TPU_CHECKPOINT_ROUNDS", "4")
    assert make_server(models, "torch").stats()["checkpoint_rounds"] == 4
