"""Barrier-driven runtime race harness over the PyTorch port's daemon — the
dynamic twin of torchguard's TG2xx lock-discipline pass
(``tools/torchguard/concurrency.py``) and the port's counterpart of
``tests/race_harness.py``.

The static pass proves the lock DISCIPLINE; this harness hammers the
port's shared structures and asserts what a race would break first:

- **parse-back integrity**: every on-disk artifact (the journal's JSON, a
  flight dump's JSONL) re-reads as whole records;
- **counter conservation**: N threads x M operations in, exactly N x M
  effects out;
- **re-registration**: a kubelet that restarts N times while ListAndWatch
  streams and Allocate calls run gets exactly one registration a restart,
  each within the plugin test's deadline, and every Allocate is answered.

Scenarios 1-4 are JAX's (``stress_journal``, ``stress_aggregator``,
``stress_flight``, ``stress_metrics``) over the port's
``AllocationJournal``, ``HeartbeatAggregator``, ``FlightRecorder`` and
``MetricsRegistry``; ``stress_reregister`` drives the port's
``plugin/server.py``. Every worker has its own ``random.Random(seed, tid)``
and jitters between operations, so a failing iteration replays by seed.
Not collected by pytest (no ``test_`` prefix): ``tests/test_torch_race.py``
runs each scenario once. Run directly::

    RACE_ITERS=20 python tests/torch_race_harness.py

Environment: ``RACE_ITERS`` (default 20), ``RACE_SEED`` (base seed,
default 0; a failure prints its seed, so ``RACE_SEED=<seed> RACE_ITERS=1``
replays it), ``RACE_THREADS`` (default 4), ``RACE_OPS`` (default 16),
``RACE_RESTARTS`` (kubelet restarts an iteration, default 3),
``RACE_ARTIFACTS`` (a directory for the last iteration's journal, guest
streams, flight dumps and summary; empty, the default, keeps none).

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import random
import shutil
import sys
import tempfile
import threading
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import grpc  # noqa: E402

from kata_xpu_device_plugin_tpu_torch.obs import flight  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.obs.flight import FlightRecorder  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.plugin.api import deviceplugin_pb2 as pb  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.plugin.api import glue  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.plugin.health import HealthWatcher  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.plugin.manager import (  # noqa: E402
    AllocationJournal,
    HeartbeatAggregator,
)
from kata_xpu_device_plugin_tpu_torch.plugin.server import (  # noqa: E402
    DevicePluginServer,
    DeviceState,
    WatchedDevice,
)

DEFAULT_THREADS = 4
DEFAULT_OPS = 16
DEFAULT_RESTARTS = 3
# The re-registration deadline of tests/test_torch_plugin.py
# (test_kubelet_restart_reregisters): a restart must land within it.
REREGISTER_DEADLINE_S = 5.0
RESOURCE = "nvidia.com/gpu"
_JITTER_S = 0.0003


def run_threads(n: int, worker, seed: int) -> None:
    """Start ``n`` workers behind one barrier, join them, re-raise the first
    failure. ``worker(tid, rng)`` gets a per-thread seeded RNG."""
    barrier = threading.Barrier(n)
    errors: list = []

    def body(tid: int) -> None:
        rng = random.Random(seed * 1009 + tid)
        try:
            barrier.wait(timeout=30)
            worker(tid, rng)
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append((tid, exc))

    threads = [threading.Thread(target=body, args=(tid,), name=f"race-{tid}")
               for tid in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise AssertionError(f"workers wedged (deadlock?): {alive}")
    if errors:
        tid, exc = errors[0]
        raise AssertionError(
            f"{len(errors)} worker(s) failed; first: thread {tid}: "
            f"{type(exc).__name__}: {exc}") from exc


# ----- JAX's four scenarios, over the port's structures ----------------------


def stress_journal(workdir: str, threads: int = DEFAULT_THREADS,
                   ops: int = DEFAULT_OPS, seed: int = 0) -> dict:
    """Concurrent ``record()`` (the Allocate handlers' path): every entry
    survives and the journal parses back whole."""
    path = os.path.join(workdir, "journal.json")
    journal = AllocationJournal(path)

    def worker(tid: int, rng: random.Random) -> None:
        for i in range(ops):
            journal.record(RESOURCE, [f"gpu-{tid}-{i}"])
            time.sleep(rng.random() * _JITTER_S)

    run_threads(threads, worker, seed)
    expect = threads * ops
    with open(path, encoding="utf-8") as fh:
        devices = json.load(fh)["devices"]  # raises on a torn write
    assert len(devices) == expect, f"journal lost entries: {len(devices)}/{expect}"
    groups = AllocationJournal(path).allocations(RESOURCE)
    assert len(groups) == expect, f"parse-back lost groups: {len(groups)}/{expect}"
    return {"scenario": "journal", "entries": len(devices), "expected": expect}


def stress_aggregator(workdir: str, threads: int = DEFAULT_THREADS,
                      ops: int = DEFAULT_OPS, seed: int = 0) -> dict:
    """Heartbeat writers (one stream a guest, append-mode like the sink),
    one polling thread and one snapshot thread at once: every heartbeat is
    consumed exactly once and ``snapshot()`` never sees a torn poll."""
    events_dir = os.path.join(workdir, "guest-events")
    os.makedirs(events_dir, exist_ok=True)
    agg = HeartbeatAggregator(events_dir, poll_interval_s=0.001)
    consumed = [0]
    writers_left = [threads]
    count_lock = threading.Lock()
    writers_done = threading.Event()

    def writer(tid: int, rng: random.Random) -> None:
        path = os.path.join(events_dir, f"guest_{tid}.jsonl")
        with open(path, "a", encoding="utf-8") as fh:
            for i in range(ops):
                fh.write(json.dumps({
                    "ts": time.time(), "kind": "serving",
                    "name": "serving_heartbeat", "server": f"s{tid}",
                    "round": i, "tokens_per_s": 100.0 + i, "queued": 0,
                    "interval_rounds": 1}) + "\n")
                fh.flush()
                time.sleep(rng.random() * _JITTER_S)
        with count_lock:
            writers_left[0] -= 1
            if writers_left[0] == 0:
                writers_done.set()

    def worker(tid: int, rng: random.Random) -> None:
        if tid < threads:
            writer(tid, rng)
        elif tid == threads:  # the one poller, racing the writers
            while not writers_done.is_set():
                got = agg.poll_once()
                with count_lock:
                    consumed[0] += got
                time.sleep(rng.random() * _JITTER_S)
        else:  # the SIGUSR1 debug-report path, mid-poll
            while not writers_done.is_set():
                assert isinstance(agg.snapshot(), dict)
                time.sleep(rng.random() * _JITTER_S)

    run_threads(threads + 2, worker, seed)
    consumed[0] += agg.poll_once()  # what the poller missed at the end
    expect = threads * ops
    assert consumed[0] == expect, (
        f"heartbeats lost or double-consumed: {consumed[0]}/{expect}")
    snap = agg.snapshot()
    assert len(snap) == threads, f"snapshot lost servers: {len(snap)}/{threads}"
    return {"scenario": "aggregator", "consumed": consumed[0],
            "expected": expect, "servers": len(snap)}


def stress_flight(workdir: str, threads: int = DEFAULT_THREADS,
                  ops: int = DEFAULT_OPS, seed: int = 0) -> dict:
    """Concurrent ``record()`` into the ring with a dump taken mid-race:
    every dump parses line-complete and the final one holds every event."""
    rec = FlightRecorder(capacity=threads * ops)
    dump_paths: list = []

    def worker(tid: int, rng: random.Random) -> None:
        for i in range(ops):
            rec.record({"ts": time.time(), "kind": "serving", "name": "tok",
                        "tid": tid, "i": i})
            if tid == 0 and i == ops // 2:
                path = rec.dump("race_mid")
                if path:
                    dump_paths.append(path)
            time.sleep(rng.random() * _JITTER_S)

    prev_dir = os.environ.get(flight.ENV_DIR)
    os.environ[flight.ENV_DIR] = workdir
    try:
        run_threads(threads, worker, seed)
        final = rec.dump("race_final")
    finally:
        if prev_dir is None:
            os.environ.pop(flight.ENV_DIR, None)
        else:
            os.environ[flight.ENV_DIR] = prev_dir
    assert final is not None
    dump_paths.append(final)
    expect = threads * ops
    final_count = 0
    for path in dump_paths:
        with open(path, encoding="utf-8") as fh:
            events = [json.loads(line) for line in fh.read().splitlines()]
        assert all("name" in ev for ev in events)
        if path == final:
            final_count = len(events)
    assert final_count == expect, (
        f"flight ring lost events: final dump {final_count}/{expect}")
    return {"scenario": "flight", "events": final_count, "expected": expect,
            "dumps": list(dump_paths)}


def stress_metrics(workdir: str, threads: int = DEFAULT_THREADS,
                   ops: int = DEFAULT_OPS, seed: int = 0) -> dict:
    """Concurrent first use and increments of one counter of a fresh
    registry: one collector for every thread, no increment lost."""
    del workdir
    reg = MetricsRegistry()
    collectors: list = []

    def worker(tid: int, rng: random.Random) -> None:
        for _ in range(ops):
            c = reg.counter("race_ops", "harness ops", ["tid"])
            collectors.append(c)
            c.labels(tid=str(tid)).inc()
            time.sleep(rng.random() * _JITTER_S)

    run_threads(threads, worker, seed)
    assert len(set(map(id, collectors))) == 1, (
        "factory returned distinct collectors for one name")
    total = sum(collectors[0].labels(tid=str(t)).get() for t in range(threads))
    expect = threads * ops
    assert total == expect, f"increments lost: {total}/{expect}"
    return {"scenario": "metrics", "total": int(total), "expected": expect}


# ----- the kubelet restart -------------------------------------------------------


class StandInKubelet(glue.RegistrationServicer):
    """Serves Registration on ``<socket_dir>/kubelet.sock`` and records each
    registration with its time; ``restart()`` stops it, wipes the plugin
    sockets beside it (what a restarting kubelet does to its directory)
    and serves again."""

    def __init__(self, socket_dir: str):
        self.socket_dir = socket_dir
        self.socket_path = os.path.join(socket_dir, "kubelet.sock")
        self.registrations: list = []  # (monotonic time, endpoint)
        self.registered = threading.Condition()
        self._server = None

    def Register(self, request, context):
        with self.registered:
            self.registrations.append((time.monotonic(), request.endpoint))
            self.registered.notify_all()
        return pb.Empty()

    def start(self) -> "StandInKubelet":
        from concurrent import futures

        server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        glue.add_registration_to_server(self, server)
        server.add_insecure_port(f"unix://{self.socket_path}")
        server.start()
        self._server = server
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.2).wait()
            self._server = None

    def restart(self) -> None:
        self.stop()
        for name in os.listdir(self.socket_dir):
            if name.endswith(".sock"):
                os.unlink(os.path.join(self.socket_dir, name))
        self.start()

    def wait_for(self, count: int, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self.registered:
            while len(self.registrations) < count:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.registered.wait(left)
        return True


class _Allocator:
    """Every device id answers with an env naming it."""

    def allocate(self, device_ids):
        return pb.ContainerAllocateResponse(
            envs={"TPU_VISIBLE_CHIPS": ",".join(device_ids)})

    def preferred(self, available, must_include, size):
        return list(must_include) + [d for d in available
                                     if d not in must_include][: size]


def _short_dir() -> str:
    # unix socket paths are capped (~108 bytes): a short root under /tmp.
    return tempfile.mkdtemp(prefix="tr-", dir="/tmp")


def stress_reregister(workdir: str, threads: int = DEFAULT_THREADS,
                      ops: int = DEFAULT_OPS, seed: int = 0,
                      restarts: int = DEFAULT_RESTARTS) -> dict:
    """A kubelet that restarts ``restarts`` times while ``threads`` workers
    run ListAndWatch streams and Allocate calls against the plugin: each
    restart, seen by the health watcher's pass, re-registers exactly once
    within :data:`REREGISTER_DEADLINE_S`; every Allocate is answered (a
    call that meets the restart's closed socket is retried)."""
    del workdir
    root = _short_dir()
    kubelet = StandInKubelet(root).start()
    plugin = DevicePluginServer(
        RESOURCE, DeviceState([WatchedDevice(str(i)) for i in range(8)]),
        _Allocator(), socket_dir=root, register_backoff_s=0.05)
    watcher = HealthWatcher([plugin], use_inotify=False)
    stop = threading.Event()
    answered = [0]
    streams = [0]
    lock = threading.Lock()
    latencies: list = []
    try:
        plugin.start()
        if not kubelet.wait_for(1, REREGISTER_DEADLINE_S):
            raise AssertionError("the plugin never registered")

        def client(tid: int, rng: random.Random) -> None:
            # Odd workers are the kubelet's ListAndWatch side: one channel
            # held across every restart, its stream re-opened after each
            # (gRPC reconnects the channel itself). Even workers call
            # Allocate on a fresh channel each time.
            done = 0
            held = (grpc.insecure_channel(f"unix://{plugin.socket_path}")
                    if tid % 2 else None)
            try:
                while done < ops and not stop.is_set():
                    try:
                        if held is not None:
                            it = glue.DevicePluginStub(held).ListAndWatch(
                                pb.Empty(), timeout=5, wait_for_ready=True)
                            assert len(next(it).devices) == 8
                            it.cancel()
                            with lock:
                                streams[0] += 1
                        else:
                            ids = [str(i) for i in rng.sample(range(8), 2)]
                            with grpc.insecure_channel(
                                    f"unix://{plugin.socket_path}") as ch:
                                resp = glue.DevicePluginStub(ch).Allocate(
                                    pb.AllocateRequest(container_requests=[
                                        pb.ContainerAllocateRequest(device_ids=ids)]),
                                    timeout=5, wait_for_ready=True)
                            got = resp.container_responses[0].envs[
                                "TPU_VISIBLE_CHIPS"]
                            assert got == ",".join(ids), got
                            with lock:
                                answered[0] += 1
                        done += 1
                    except grpc.RpcError:
                        pass  # the restart closed the socket under the call
                    time.sleep(rng.random() * 20 * _JITTER_S)
            finally:
                if held is not None:
                    held.close()

        def restarter(rng: random.Random) -> None:
            try:
                for i in range(restarts):
                    time.sleep(rng.random() * 0.05)
                    kubelet.restart()
                    t0 = time.monotonic()
                    watcher.evaluate()  # sees the plugin's socket gone
                    if not kubelet.wait_for(i + 2, REREGISTER_DEADLINE_S):
                        raise AssertionError(
                            f"restart {i + 1}: no re-registration within "
                            f"{REREGISTER_DEADLINE_S} s")
                    latencies.append(round(kubelet.registrations[i + 1][0] - t0, 4))
            finally:
                stop.set()

        def worker(tid: int, rng: random.Random) -> None:
            if tid == threads:
                restarter(rng)
            else:
                client(tid, rng)

        run_threads(threads + 1, worker, seed)
        time.sleep(0.2)  # a late duplicate registration would land here
        regs = len(kubelet.registrations)
        assert regs == restarts + 1, (
            f"{regs} registrations for {restarts} restarts (want one each)")
        assert plugin.serving
        with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
            opts = glue.DevicePluginStub(ch).GetDevicePluginOptions(
                pb.Empty(), timeout=REREGISTER_DEADLINE_S, wait_for_ready=True)
            assert opts.get_preferred_allocation_available
    finally:
        stop.set()
        plugin.stop()
        kubelet.stop()
        shutil.rmtree(root, ignore_errors=True)
    return {"scenario": "reregister", "restarts": restarts,
            "registrations": regs, "reregister_s": latencies,
            "allocations": answered[0], "streams": streams[0]}


SCENARIOS = (stress_journal, stress_aggregator, stress_flight, stress_metrics,
             stress_reregister)


def run_iteration(seed: int, threads: int = DEFAULT_THREADS,
                  ops: int = DEFAULT_OPS, restarts: int = DEFAULT_RESTARTS,
                  keep_dir: str = "") -> list:
    """One pass over every scenario in a throwaway directory; returns each
    scenario's stats. ``keep_dir`` keeps the artifacts (journal, guest
    streams, flight dumps) there."""
    results = []
    workdir = tempfile.mkdtemp(prefix=f"torch_race_{seed}_")
    try:
        for scenario in SCENARIOS:
            sub = os.path.join(workdir, scenario.__name__)
            os.makedirs(sub, exist_ok=True)
            kw = {"restarts": restarts} if scenario is stress_reregister else {}
            results.append(scenario(sub, threads=threads, ops=ops, seed=seed, **kw))
        if keep_dir:
            os.makedirs(keep_dir, exist_ok=True)
            src = os.path.join(workdir, "stress_journal", "journal.json")
            if os.path.exists(src):
                shutil.copy(src, os.path.join(keep_dir, "race_journal.json"))
            streams = os.path.join(workdir, "stress_aggregator", "guest-events")
            for fname in sorted(os.listdir(streams)) if os.path.isdir(streams) else ():
                shutil.copy(os.path.join(streams, fname),
                            os.path.join(keep_dir, f"race_{fname}"))
            for res in results:
                for dump in res.get("dumps", ()):
                    if os.path.exists(dump):
                        shutil.copy(dump, os.path.join(keep_dir,
                                                       os.path.basename(dump)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return results


def main() -> int:
    iters = int(os.environ.get("RACE_ITERS", "20"))
    threads = int(os.environ.get("RACE_THREADS", str(DEFAULT_THREADS)))
    ops = int(os.environ.get("RACE_OPS", str(DEFAULT_OPS)))
    restarts = int(os.environ.get("RACE_RESTARTS", str(DEFAULT_RESTARTS)))
    seed0 = int(os.environ.get("RACE_SEED", "0"))
    artifacts = os.environ.get("RACE_ARTIFACTS", "")
    t0 = time.time()
    results: list = []
    slowest = 0.0
    for it in range(iters):
        seed = seed0 + it
        keep = artifacts if it == iters - 1 else ""
        try:
            results = run_iteration(seed, threads, ops, restarts, keep)
        except AssertionError as exc:
            print(f"race harness FAILED at iteration {it} (seed={seed} — replay "
                  f"with RACE_SEED={seed} RACE_ITERS=1): {exc}", file=sys.stderr)
            return 1
        for res in results:
            slowest = max([slowest, *res.get("reregister_s", ())])
        if (it + 1) % 10 == 0 or it == iters - 1:
            print(f"race harness: {it + 1}/{iters} iterations clean "
                  f"({time.time() - t0:.1f}s)", flush=True)
    summary = {"iterations": iters, "threads": threads, "ops": ops,
               "restarts": restarts, "elapsed_s": round(time.time() - t0, 2),
               "slowest_reregister_s": slowest, "last_iteration": results}
    if artifacts:
        os.makedirs(artifacts, exist_ok=True)
        with open(os.path.join(artifacts, "race_summary.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(summary, fh, indent=2)
            fh.write("\n")
    print(json.dumps({k: v for k, v in summary.items() if k != "last_iteration"}))
    print(f"race harness: {iters} iterations x {threads} threads x {ops} ops, "
          f"{restarts} kubelet restarts each — zero lost or torn events, "
          "journal entries or registrations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
