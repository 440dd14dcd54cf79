"""Kubelet device-plugin server (counterpart of
``kata_xpu_device_plugin_tpu/plugin/server.py``): Register, ListAndWatch,
GetPreferredAllocation, Allocate and PreStartContainer over a unix socket.

The reference's ``GenericDevicePlugin`` (``generic_device_plugin.go:
37-386``), without its concurrency quirks:

- all device state behind one lock, ListAndWatch streams read snapshots
  (the reference races on shared ``dpi.devs`` slices);
- restart() reuses the plugin's single lifecycle, so a kubelet restart never
  orphans the plugin from the manager's shutdown path;
- Allocate merges env instead of overwriting it;
- GetPreferredAllocation is a real, injectable policy.
"""
from __future__ import annotations

import os
import queue
import random
import threading
from concurrent import futures
from dataclasses import dataclass
from typing import Callable, Optional, Protocol, Sequence

import grpc

from .. import obs
from ..utils import log, metrics
from .api import deviceplugin_pb2 as pb
from .api import glue

LOG = log.get("server")

SOCKET_PREFIX = "kata-tpu"


@dataclass
class WatchedDevice:
    """One schedulable unit: a GPU (id = its /dev/nvidia minor) or a VFIO
    IOMMU group (id = group id)."""

    id: str
    health: str = glue.HEALTHY
    numa_node: Optional[int] = None
    # Paths whose existence gates health (/dev/nvidia<N> and its driver
    # binding, /dev/vfio/<group>).
    watch_paths: tuple[str, ...] = ()

    def to_pb(self) -> pb.Device:
        dev = pb.Device(id=self.id, health=self.health)
        if self.numa_node is not None:
            dev.topology.nodes.add(id=self.numa_node)
        return dev


class DeviceState:
    """Thread-safe device table with change subscription (the channel pair
    ``healthy``/``unhealthy`` of the reference, generalized)."""

    def __init__(self, devices: Sequence[WatchedDevice] = ()):
        self._lock = threading.Lock()
        self._devices: dict[str, WatchedDevice] = {d.id: d for d in devices}
        self._subscribers: list[queue.SimpleQueue] = []

    def snapshot(self) -> list[WatchedDevice]:
        with self._lock:
            return [
                WatchedDevice(d.id, d.health, d.numa_node, d.watch_paths)
                for d in sorted(self._devices.values(), key=_dev_sort_key)
            ]

    def ids(self) -> list[str]:
        with self._lock:
            return sorted(self._devices, key=_id_sort_key)

    def get(self, dev_id: str) -> Optional[WatchedDevice]:
        with self._lock:
            d = self._devices.get(dev_id)
            return WatchedDevice(d.id, d.health, d.numa_node, d.watch_paths) if d else None

    def set_health(self, dev_id: str, health: str) -> bool:
        """Returns True when the device existed and its health changed."""
        with self._lock:
            dev = self._devices.get(dev_id)
            if dev is None or dev.health == health:
                return False
            dev.health = health
        self._notify()
        return True

    def replace(self, devices: Sequence[WatchedDevice]) -> bool:
        """Swap the whole table (rescan path); returns True on any change."""
        with self._lock:
            new = {d.id: d for d in devices}
            changed = {i: (d.id, d.health) for i, d in new.items()} != {
                i: (d.id, d.health) for i, d in self._devices.items()
            }
            self._devices = new
        if changed:
            self._notify()
        return changed

    def subscribe(self) -> queue.SimpleQueue:
        q: queue.SimpleQueue = queue.SimpleQueue()
        with self._lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, q: queue.SimpleQueue) -> None:
        with self._lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def _notify(self) -> None:
        with self._lock:
            subs = list(self._subscribers)
        for q in subs:
            q.put(None)  # wake-up token; streams re-snapshot


def _id_sort_key(i: str):
    return (0, int(i)) if i.isdigit() else (1, i)


def _dev_sort_key(d: WatchedDevice):
    return _id_sort_key(d.id)


class Allocator(Protocol):
    """Resource-specific Allocate/preferred policy, injected into the server."""

    def allocate(self, device_ids: Sequence[str]) -> pb.ContainerAllocateResponse:
        """Build one container's response; raise AllocationError to reject."""
        ...

    def preferred(
        self, available: Sequence[str], must_include: Sequence[str], size: int
    ) -> list[str]:
        ...


class AllocationError(Exception):
    pass


class DevicePluginServer(glue.DevicePluginServicer):
    """Serves one extended resource on one unix socket, registers with the
    kubelet, streams device health (ref ``Start``/``Register``/``ListAndWatch``
    lifecycle, generic_device_plugin.go:128-250)."""

    def __init__(
        self,
        resource_name: str,
        state: DeviceState,
        allocator: Allocator,
        socket_dir: str = glue.KUBELET_SOCKET_DIR,
        kubelet_socket: str = "",
        pre_start_required: bool = False,
        on_allocate: Optional[Callable[[Sequence[str]], None]] = None,
        register_attempts: int = 5,
        register_backoff_s: float = 1.0,
        register_backoff_max_s: float = 30.0,
        register_dial_timeout_s: float = 5.0,
    ):
        self.resource_name = resource_name
        self.state = state
        self.allocator = allocator
        self.socket_dir = socket_dir
        self.kubelet_socket = kubelet_socket or os.path.join(socket_dir, "kubelet.sock")
        self.pre_start_required = pre_start_required
        self.on_allocate = on_allocate
        # Registration retry policy, from Config (--register-attempts /
        # --register-backoff-s).
        self.register_attempts = int(register_attempts)
        self.register_backoff_s = float(register_backoff_s)
        self.register_backoff_max_s = float(register_backoff_max_s)
        self.register_dial_timeout_s = float(register_dial_timeout_s)
        self.endpoint = f"{SOCKET_PREFIX}-{resource_name.replace('/', '-')}.sock"
        self._server: Optional[grpc.Server] = None
        self._stop = threading.Event()  # one lifecycle event, never replaced
        self._serving = threading.Event()
        self._lock = threading.Lock()

    # ----- lifecycle -------------------------------------------------------

    @property
    def socket_path(self) -> str:
        return os.path.join(self.socket_dir, self.endpoint)

    def start(self, register: bool = True) -> None:
        with self._lock:
            self._start_locked(register)

    def _start_locked(self, register: bool) -> None:
        os.makedirs(self.socket_dir, exist_ok=True)
        try:
            os.unlink(self.socket_path)
        except FileNotFoundError:
            pass
        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            options=(("grpc.max_receive_message_length", 16 * 1024 * 1024),),
        )
        glue.add_device_plugin_to_server(self, server)
        server.add_insecure_port(f"unix://{self.socket_path}")
        server.start()
        self._server = server
        self._wait_ready()
        self._serving.set()
        if register:
            self.register()
        LOG.info(
            "plugin serving",
            extra=log.kv(resource=self.resource_name, socket=self.socket_path),
        )

    def _wait_ready(self, timeout: float = 5.0) -> None:
        """Self-dial until our socket answers (ref waitForGrpcServer,
        generic_device_plugin.go:98-115 — without the leaked context)."""
        with grpc.insecure_channel(f"unix://{self.socket_path}") as ch:
            grpc.channel_ready_future(ch).result(timeout=timeout)

    def register(self, attempts: Optional[int] = None,
                 backoff_s: Optional[float] = None) -> None:
        """Register with retry/backoff — a restarting kubelet can take longer
        than one dial timeout to come back (the reference fails hard once,
        generic_device_plugin.go:204-209). Policy comes from the
        constructor (``Config.register_attempts`` / ``register_backoff_s``
        on the daemon path); the exponential backoff is CAPPED at
        ``register_backoff_max_s`` and JITTERED (up to +25%) so a node's
        plugins do not hammer a recovering kubelet in lockstep. Exhausting
        every attempt emits a ``registration_exhausted`` obs event before
        raising — the daemon's death is diagnosable from the event
        stream, not silent."""
        attempts = self.register_attempts if attempts is None else attempts
        backoff_s = self.register_backoff_s if backoff_s is None else backoff_s
        last: Exception | None = None
        for attempt in range(attempts):
            if self._stop.is_set():
                return
            try:
                with grpc.insecure_channel(f"unix://{self.kubelet_socket}") as ch:
                    grpc.channel_ready_future(ch).result(
                        timeout=self.register_dial_timeout_s
                    )
                    glue.RegistrationStub(ch).Register(
                        pb.RegisterRequest(
                            version=glue.DEVICE_PLUGIN_VERSION,
                            endpoint=self.endpoint,
                            resource_name=self.resource_name,
                            options=pb.DevicePluginOptions(
                                pre_start_required=self.pre_start_required,
                                get_preferred_allocation_available=True,
                            ),
                        )
                    )
                metrics.registrations_total.labels(resource=self.resource_name).inc()
                LOG.info("registered with kubelet", extra=log.kv(resource=self.resource_name))
                return
            except (grpc.RpcError, grpc.FutureTimeoutError) as e:
                last = e
                LOG.warning(
                    "kubelet registration attempt failed",
                    extra=log.kv(
                        resource=self.resource_name,
                        attempt=attempt + 1,
                        err=str(e) or type(e).__name__,
                    ),
                )
                if attempt < attempts - 1:
                    # No dead sleep after the FINAL attempt: exhaustion
                    # should surface (event + raise) immediately.
                    delay = min(
                        backoff_s * (2**attempt), self.register_backoff_max_s
                    )
                    self._stop.wait(delay * (1.0 + 0.25 * random.random()))
        assert last is not None
        obs.emit(
            "plugin", "registration_exhausted",
            resource=self.resource_name, attempts=attempts,
            err=(str(last) or type(last).__name__)[:200],
        )
        raise last

    def restart(self) -> None:
        """Kubelet restarted (our socket vanished): re-serve and re-register
        on the SAME lifecycle — the stop event is untouched, so the manager's
        shutdown still reaches us."""
        with self._lock:
            if self._stop.is_set():
                return
            self._serving.clear()
            if self._server is not None:
                self._server.stop(grace=1.0).wait()
                self._server = None
            self._start_locked(register=True)

    def request_stop(self) -> None:
        """Server-lock-free stop request, usable while another thread is
        inside start()/register() holding the server lock: just flips the
        event that register's dial/backoff waits on. The real teardown must
        still follow via stop(). (Not async-signal-safe — call from a normal
        thread, e.g. the daemon's signal-watcher, never a signal handler.)"""
        self._stop.set()

    def stop(self) -> None:
        # Set the stop flag BEFORE taking the lock: a concurrent restart()
        # may hold it through register()'s retry/backoff, and the flag is
        # what makes those waits return immediately.
        self._stop.set()
        with self._lock:
            self._serving.clear()
            if self._server is not None:
                self._server.stop(grace=1.0).wait()
                self._server = None
            try:
                os.unlink(self.socket_path)
            except FileNotFoundError:
                pass

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    @property
    def serving(self) -> bool:
        return self._serving.is_set()

    # ----- kubelet-facing API ---------------------------------------------

    def GetDevicePluginOptions(self, request, context) -> pb.DevicePluginOptions:
        return pb.DevicePluginOptions(
            pre_start_required=self.pre_start_required,
            get_preferred_allocation_available=True,
        )

    def ListAndWatch(self, request, context):
        """Initial device list, then a fresh snapshot on every state change
        (ref generic_device_plugin.go:222-250, without the shared-slice races)."""
        q = self.state.subscribe()
        try:
            yield self._list_response()
            while not self._stop.is_set():
                try:
                    q.get(timeout=1.0)
                except queue.Empty:
                    if not context.is_active():
                        return
                    continue
                while True:  # coalesce bursts
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                yield self._list_response()
        finally:
            self.state.unsubscribe(q)

    def _list_response(self) -> pb.ListAndWatchResponse:
        # Snapshot build + gauge refresh latency per stream update.
        with obs.timer(
            "plugin.ListAndWatch_update",
            metric=metrics.grpc_handler_seconds.labels(
                method="ListAndWatch_update", resource=self.resource_name
            ),
            resource=self.resource_name,
        ) as sp:
            devices = self.state.snapshot()
            resp = pb.ListAndWatchResponse(devices=[d.to_pb() for d in devices])
            for health in (glue.HEALTHY, glue.UNHEALTHY):
                metrics.devices_total.labels(resource=self.resource_name, health=health).set(
                    sum(1 for d in devices if d.health == health)
                )
            sp.set(devices=len(devices))
        return resp

    def GetPreferredAllocation(self, request, context) -> pb.PreferredAllocationResponse:
        resp = pb.PreferredAllocationResponse()
        with obs.timer(
            "plugin.GetPreferredAllocation",
            metric=metrics.grpc_handler_seconds.labels(
                method="GetPreferredAllocation", resource=self.resource_name
            ),
            resource=self.resource_name,
        ):
            for creq in request.container_requests:
                try:
                    chosen = self.allocator.preferred(
                        list(creq.available_device_ids),
                        list(creq.must_include_device_ids),
                        creq.allocation_size,
                    )
                except Exception as e:  # advisory API: degrade, don't fail admission
                    LOG.warning(
                        "preferred allocation failed",
                        extra=log.kv(resource=self.resource_name, err=str(e)),
                    )
                    chosen = list(creq.available_device_ids)[: creq.allocation_size]
                resp.container_responses.add(device_ids=chosen)
        return resp

    def Allocate(self, request, context) -> pb.AllocateResponse:
        """Validate against live state and answer with CDI references
        (ref generic_device_plugin.go:320-355).

        Telemetry: the whole call runs inside one span whose trace id is
        carried by every log line it emits (the formatters attach it), so
        the "allocated" line — and through it the device ids — can be
        joined to the pod UID the kubelet's pod-resources API later
        reports for those ids. The AllocateRequest itself carries no pod
        identity (v1beta1 limitation); the trace id is the join key."""
        resp = pb.AllocateResponse()
        granted: list[str] = []
        with obs.span(
            "plugin.Allocate",
            resource=self.resource_name,
            containers=len(request.container_requests),
        ) as sp:
            for creq in request.container_requests:
                ids = list(creq.device_ids)
                for dev_id in ids:
                    dev = self.state.get(dev_id)
                    if dev is None:
                        metrics.allocations_total.labels(
                            resource=self.resource_name, outcome="unknown_device"
                        ).inc()
                        context.abort(
                            grpc.StatusCode.INVALID_ARGUMENT,
                            f"unknown device id {dev_id!r} for {self.resource_name}",
                        )
                    if dev.health != glue.HEALTHY:
                        metrics.allocations_total.labels(
                            resource=self.resource_name, outcome="unhealthy"
                        ).inc()
                        context.abort(
                            grpc.StatusCode.UNAVAILABLE,
                            f"device {dev_id} of {self.resource_name} is unhealthy",
                        )
                try:
                    cresp = self.allocator.allocate(ids)
                except AllocationError as e:
                    metrics.allocations_total.labels(
                        resource=self.resource_name, outcome="rejected"
                    ).inc()
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                resp.container_responses.append(cresp)
                metrics.allocations_total.labels(
                    resource=self.resource_name, outcome="ok"
                ).inc()
                metrics.allocation_chips_total.labels(resource=self.resource_name).inc(len(ids))
                if self.on_allocate:
                    self.on_allocate(ids)
                LOG.info(
                    "allocated",
                    extra=log.kv(resource=self.resource_name, devices=",".join(ids)),
                )
                # Accumulate across containers: the span event is the
                # device-ids↔pod join record for the WHOLE request.
                granted.extend(ids)
                sp.set(devices=",".join(granted))
        metrics.grpc_handler_seconds.labels(
            method="Allocate", resource=self.resource_name
        ).observe(sp.duration_s)
        return resp

    def PreStartContainer(self, request, context) -> pb.PreStartContainerResponse:
        return pb.PreStartContainerResponse()
