"""Device and socket health watching (counterpart of
``kata_xpu_device_plugin_tpu/plugin/health.py``).

The reference's fsnotify ``healthCheck`` goroutine
(``generic_device_plugin.go:389-457``) watches device nodes to flip
Healthy/Unhealthy in the ListAndWatch stream, and the plugin's own socket to
detect a kubelet restart and re-register. Here:

- inotify (ctypes, :mod:`..utils.inotify`) speeds up a periodic existence
  poll rather than replacing it: char devices do not reliably emit
  create/remove events, and a poll converges even when events are lost;
- health is driver-level, not only dev-node existence. Each GPU watches its
  ``/dev/nvidia<N>`` node and its driver binding, the PCI function's
  ``driver`` link in sysfs, which an unbind removes while the node lingers
  (``manager.gpu_watched_devices`` pairs them up). On top of existence,
  :func:`node_alive` classifies char devices by a non-blocking ``open()``:
  an orphaned inode whose driver is gone answers ``ENXIO``/``ENODEV``
  (dead) though the path exists, while a node held exclusively elsewhere
  answers ``EBUSY`` (alive). The probe is never aimed at a device that
  looks healthy, only at confirming recovery of an Unhealthy one, and at
  allocate time;
- one watcher serves all plugins, and a failed re-registration after a
  kubelet restart is retried under capped exponential backoff.
"""
from __future__ import annotations

import errno
import os
import threading
import time
from typing import Sequence

from .. import obs
from ..discovery.sysfs import open_probe
from ..utils import inotify, log, metrics
from .api import glue
from .server import DevicePluginServer

LOG = log.get("health")

#: errnos from open(2) on a char device that mean "the driver behind this
#: inode is gone" — the node is a leftover the unbind didn't clean up — and
#: the probe's answer for a path that is not there.
_DEAD_ERRNOS = frozenset({errno.ENXIO, errno.ENODEV, errno.ENOENT})


def node_alive(path: str) -> bool:
    """Driver-level liveness of a device path (ref re-validates sysfs at
    allocate time, ``generic_device_plugin.go:329-338``; for a driver's char
    device the equivalent signal lives behind the inode, not in the path).

    - missing path → dead;
    - regular files / directories / sysfs entries → existence is the signal;
    - char devices → :func:`..discovery.sysfs.open_probe`, classified by
      errno: ``ENXIO``/``ENODEV`` mean the driver no longer backs the inode
      (dead); anything else — notably ``EBUSY``/``EACCES`` from a guest's
      exclusive open — means a live driver answered (alive).
    """
    return open_probe(path) not in _DEAD_ERRNOS


class HealthWatcher(threading.Thread):
    def __init__(
        self,
        plugins: Sequence[DevicePluginServer],
        poll_interval_s: float = 5.0,
        use_inotify: bool = True,
        restart_backoff_s: float = 1.0,
        restart_backoff_max_s: float = 60.0,
        clock=time.monotonic,
    ):
        super().__init__(name="health-watcher", daemon=True)
        self._plugins = list(plugins)
        self._poll_interval = poll_interval_s
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # Restart retry state: every evaluate() pass re-offers a failed
        # plugin.restart() under bounded exponential backoff, so a lost
        # socket event cannot leave a plugin dead:
        # {id(plugin): (consecutive_failures, not_before_t)}.
        self._restart_backoff_s = restart_backoff_s
        self._restart_backoff_max_s = restart_backoff_max_s
        self._restart_state: dict[int, tuple[int, float]] = {}
        self._clock = clock
        self._ino: inotify.Inotify | None = None
        if use_inotify:
            try:
                self._ino = inotify.Inotify()
            except OSError as e:
                LOG.warning("inotify unavailable, polling only", extra=log.kv(err=str(e)))

    def add_plugin(self, plugin: DevicePluginServer) -> None:
        with self._lock:
            self._plugins.append(plugin)
        self._sync_watches()

    def remove_plugin(self, plugin: DevicePluginServer) -> None:
        with self._lock:
            if plugin in self._plugins:
                self._plugins.remove(plugin)

    def stop(self) -> None:
        self._stop.set()

    # ----- internals -------------------------------------------------------

    def _watched_dirs(self) -> set[str]:
        dirs: set[str] = set()
        with self._lock:
            plugins = list(self._plugins)
        for p in plugins:
            dirs.add(p.socket_dir)
            for dev in p.state.snapshot():
                for path in dev.watch_paths:
                    dirs.add(os.path.dirname(path))
        return dirs

    def _sync_watches(self) -> None:
        if self._ino is None:
            return
        for d in self._watched_dirs():
            if os.path.isdir(d):
                try:
                    self._ino.add_watch(d)
                except OSError:
                    pass

    def run(self) -> None:
        self._sync_watches()
        while not self._stop.is_set():
            if self._ino is not None:
                # Block on events up to the poll interval, then evaluate:
                # events make reaction immediate, the poll makes it converge.
                self._ino.read_events(timeout=self._poll_interval)
            else:
                self._stop.wait(self._poll_interval)
            if self._stop.is_set():
                return
            self.evaluate()
            self._sync_watches()  # directories may have (re)appeared

    def evaluate(self) -> None:
        """One convergence pass; also called directly by tests for determinism."""
        with self._lock:
            plugins = list(self._plugins)
        for plugin in plugins:
            if plugin.stopped:
                # A stopped plugin no longer serves or watches anything:
                # its gauge must not keep reporting the last live count.
                metrics.chips_quarantined.labels(
                    resource=plugin.resource_name
                ).set(0)
                continue
            unhealthy = 0
            for dev in plugin.state.snapshot():
                if not dev.watch_paths:
                    if dev.health == glue.UNHEALTHY:
                        unhealthy += 1
                    continue
                # Existence of the dev+driver-state pair decides steady-state
                # health WITHOUT open()ing anything: probing a healthy,
                # possibly guest-held node every poll would race the VMM's
                # exclusive open (the watcher winning the race fails VM
                # startup). The open-probe classifier runs only to confirm
                # RECOVERY of an already-Unhealthy device — a lingering node
                # must answer open(2) (or be guest-held, EBUSY) before it
                # flips back to Healthy — and at allocate time
                # (``manager.gpu_chip_alive``).
                alive = all(os.path.exists(p) for p in dev.watch_paths)
                if alive and dev.health == glue.UNHEALTHY:
                    alive = all(node_alive(p) for p in dev.watch_paths)
                health = glue.HEALTHY if alive else glue.UNHEALTHY
                if health == glue.UNHEALTHY:
                    unhealthy += 1
                if plugin.state.set_health(dev.id, health):
                    metrics.health_transitions_total.labels(
                        resource=plugin.resource_name, to=health
                    ).inc()
                    # One event per flip, so the guest's tp_degraded stream
                    # and the daemon's quarantine stream join on the same
                    # incident; re-admission emits too, so a flap shows
                    # as the pair.
                    obs.emit(
                        "plugin",
                        "chip_quarantined" if health == glue.UNHEALTHY
                        else "chip_readmitted",
                        resource=plugin.resource_name, device=dev.id,
                    )
                    LOG.info(
                        "device health changed",
                        extra=log.kv(
                            resource=plugin.resource_name, device=dev.id, health=health
                        ),
                    )
            metrics.chips_quarantined.labels(
                resource=plugin.resource_name
            ).set(unhealthy)
            # Kubelet restart wipes the plugin-socket dir (ref :444-453).
            if plugin.serving and not os.path.exists(plugin.socket_path):
                self._try_restart(plugin)

    def _try_restart(self, plugin: DevicePluginServer) -> bool:
        """One bounded-backoff restart offer. A failure schedules the next
        attempt (exponential, capped) and is re-offered by every later
        evaluate() pass — the periodic poll guarantees convergence even
        when no further socket event arrives; success clears the backoff.
        Both outcomes land on ``plugin_restarts_total{ok=...}`` and
        failures additionally emit a ``plugin_restart_failed`` obs
        event."""
        # Backoff state joins _plugins under this class's lock: the
        # watcher thread is its only writer today, but add()/remove()
        # callers share the instance and the map must not be one
        # refactor away from a torn read.
        with self._lock:
            fails, not_before = self._restart_state.get(
                id(plugin), (0, 0.0)
            )
        now = self._clock()
        if now < not_before:
            return False  # backing off; a later pass re-offers
        LOG.info(
            "plugin socket removed (kubelet restart?), re-registering",
            extra=log.kv(resource=plugin.resource_name, attempt=fails + 1),
        )
        try:
            plugin.restart()
        except Exception as e:
            fails += 1
            delay = min(
                self._restart_backoff_s * (2 ** (fails - 1)),
                self._restart_backoff_max_s,
            )
            with self._lock:
                self._restart_state[id(plugin)] = (fails, now + delay)
            metrics.plugin_restarts_total.labels(
                resource=plugin.resource_name, ok="false"
            ).inc()
            obs.emit(
                "plugin", "plugin_restart_failed",
                resource=plugin.resource_name, attempt=fails,
                err=str(e)[:200], retry_in_s=round(delay, 3),
            )
            LOG.error(
                "plugin restart failed",
                extra=log.kv(
                    resource=plugin.resource_name, err=str(e),
                    attempt=fails, retry_in_s=delay,
                ),
            )
            return False
        with self._lock:
            self._restart_state.pop(id(plugin), None)
        metrics.plugin_restarts_total.labels(
            resource=plugin.resource_name, ok="true"
        ).inc()
        return True
