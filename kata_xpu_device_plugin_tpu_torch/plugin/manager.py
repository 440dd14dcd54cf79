"""Orchestration: discovery → CDI specs → plugin servers → rescan loop
(counterpart of ``kata_xpu_device_plugin_tpu/plugin/manager.py``).

The reference's ``InitiateDevicePlugin`` + ``generateCDISpec`` +
``createDevicePlugins`` (``device_plugin.go:44-124``), with what the
reference lacks: periodic re-discovery, one shutdown path for every plugin,
per-kind CDI spec files, the allocation journal and the guest heartbeat
aggregator, and the host's multi-host identity (:mod:`..multihost`)
overlaid on every scan.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional, Sequence

from .. import cdi, obs
from ..cdi import constants as C
from ..config import Config
from ..discovery import pciids
from ..discovery.gpu import GpuInventory, scan_gpus
from ..discovery.sysfs import PCI_DEVICES_SUBDIR, read_id_file, read_link_base
from ..discovery.vfio import VfioInventory, scan_vfio
from ..multihost import resolve_membership
from ..multihost.resolver import persist_membership
from ..topology import runtime_env
from ..utils import log, metrics
from . import health
from .allocators import GpuAllocator, VfioAllocator
from .health import HealthWatcher
from .server import DevicePluginServer, DeviceState, WatchedDevice

LOG = log.get("manager")


# ----- CDI spec builders ---------------------------------------------------


def build_gpu_spec(inv: GpuInventory, cfg: Config) -> cdi.Spec:
    """CDI spec of the GPUs (ref ``generateCDISpec``, device_plugin.go:
    55-80, redesigned): per-GPU ``/dev/nvidia<N>`` nodes; at spec level the
    driver's shared nodes (each only where it exists) and the host's static
    env, shared by every allocation."""
    spec = cdi.Spec(kind=cfg.gpu_cdi_kind, cdi_version=C.CDI_VERSION)
    for key, val in sorted(runtime_env(inv.topology).items()):
        spec.container_edits.add_env(key, val)
    for name in C.SHARED_NODES:
        host_path = os.path.join(cfg.dev_root, name)
        if os.path.exists(host_path):
            spec.container_edits.device_nodes.append(
                cdi.DeviceNode(
                    path=f"/dev/{name}", host_path=host_path, type="c",
                    permissions="rw",
                )
            )
    for chip in inv.chips:
        annotations = {}
        if cfg.kata_annotations and chip.pci_address:
            annotations[C.ANNOTATION_BDF] = chip.pci_address
        edits = cdi.ContainerEdits(
            device_nodes=[
                cdi.DeviceNode(
                    path=_container_dev_path(chip.dev_path, cfg.dev_root),
                    host_path=chip.dev_path,
                    type="c",
                    major=chip.major,
                    minor=chip.minor,
                    permissions="rw",
                )
            ]
        )
        spec.add_device(
            cdi.Device(name=str(chip.index), annotations=annotations, container_edits=edits)
        )
    return spec


def build_vfio_spec(inv: VfioInventory, cfg: Config) -> cdi.Spec:
    """CDI spec for whole-VM passthrough groups: one CDI device per IOMMU
    group carrying its /dev/vfio node and Kata hot-plug annotations."""
    spec = cdi.Spec(kind=cfg.vfio_cdi_kind, cdi_version=C.CDI_VERSION)
    for group in sorted(inv.groups, key=lambda g: (len(g), g)):
        devs = inv.groups[group]
        annotations = {}
        if cfg.kata_annotations:
            annotations[C.ANNOTATION_ATTACH_PCI] = "true"
            annotations[C.ANNOTATION_BDF] = ",".join(d.address for d in devs)
        spec.add_device(
            cdi.Device(
                name=group,
                annotations=annotations,
                container_edits=cdi.ContainerEdits(
                    device_nodes=[
                        cdi.DeviceNode(
                            path=f"/dev/vfio/{group}",
                            host_path=os.path.join(cfg.dev_root, "vfio", group),
                            type="c",
                            permissions="rw",
                        )
                    ]
                ),
            )
        )
    return spec


def _container_dev_path(host_path: str, dev_root: str) -> str:
    """Map a host device path to its in-guest path (identity in production
    where dev_root is /dev; fake roots in tests still emit /dev/...)."""
    if dev_root != "/dev" and host_path.startswith(dev_root):
        return "/dev" + host_path[len(dev_root):]
    return host_path




def gpu_watched_devices(
    inv: GpuInventory, sysfs_root: str = "/sys"
) -> list[WatchedDevice]:
    """Each GPU watches its /dev node and its driver binding (the PCI
    function's ``driver`` link, which an unbind removes while the node can
    linger); a GPU without a known PCI function watches its node alone. The
    same paths back allocate-time re-validation via :func:`gpu_chip_alive`."""
    return [
        WatchedDevice(
            id=str(chip.index),
            numa_node=chip.numa_node,
            watch_paths=gpu_chip_watch_paths(chip, sysfs_root),
        )
        for chip in inv.chips
    ]


def gpu_chip_watch_paths(chip, sysfs_root: str = "/sys") -> tuple[str, ...]:
    """(dev node, driver binding) — the liveness paths of one GPU."""
    if not chip.pci_address:
        return (chip.dev_path,)
    return (chip.dev_path,
            os.path.join(sysfs_root, PCI_DEVICES_SUBDIR, chip.pci_address, "driver"))


def gpu_chip_alive(chip, sysfs_root: str = "/sys") -> bool:
    """Allocate-time liveness: the GPU's node answers a non-blocking open
    probe (or is held elsewhere) AND its driver binding still exists — the
    ref's sysfs re-validation (``generic_device_plugin.go:329-338``) over
    the paths the health watcher tracks, so a GPU the watcher would flag
    Unhealthy is never handed to a pod before the next health pass."""
    return all(health.node_alive(p) for p in gpu_chip_watch_paths(chip, sysfs_root))


def vfio_watched_devices(
    inv: VfioInventory, groups: list[str], dev_root: str
) -> list[WatchedDevice]:
    return [
        WatchedDevice(
            id=g,
            numa_node=inv.groups[g][0].numa_node if inv.groups.get(g) else None,
            watch_paths=(os.path.join(dev_root, "vfio", g),),
        )
        for g in groups
    ]


# ----- allocation-state journal --------------------------------------------


class AllocationJournal:
    """Crash-consistent record of device→allocation assignments.

    The kubelet owns allocation truth but never replays it to a
    restarting plugin (v1beta1 has no ListAllocations), so the reference
    plugin restarts BLIND: allocations made before the restart are
    invisible, and a device that died while the daemon was down is only
    noticed when a pod crashes on it. This journal closes that hole with
    a reconcile-from-observed-state loop: every Allocate checkpoints its
    device→group assignment to disk (atomic tmp+rename), and a
    restarting daemon reconciles the journal against the devices it
    actually observes — ``alloc_reconciled`` for groups whose devices
    all still exist, ``alloc_orphaned`` (entry dropped, gauge set) for
    groups referencing vanished devices.

    Entries are keyed by device id: a device belongs to at most one live
    allocation (the kubelet only re-hands-out freed devices), so the
    journal is bounded by device count and a re-allocation of a device
    supersedes its old entry. A missing or corrupt file degrades to an
    empty journal — observed state is the authority, the journal is the
    hint."""

    def __init__(self, path: str):
        self.path = path
        # Allocate handlers run on the gRPC thread pool: record() calls
        # arrive concurrently, and an unguarded dict would race json.dump
        # mid-write (and two writers would fight over the same tmp file).
        self._lock = threading.Lock()
        self._devices: dict[str, dict] = {}
        try:
            with open(path, encoding="utf-8") as fh:
                data = json.load(fh)
            devices = data.get("devices", {})
            if isinstance(devices, dict):
                self._devices = {
                    str(k): v for k, v in devices.items()
                    if isinstance(v, dict) and v.get("group")
                }
        except FileNotFoundError:
            pass
        except (OSError, ValueError) as e:
            LOG.warning(
                "allocation journal unreadable — starting empty",
                extra=log.kv(path=path, err=str(e)),
            )

    def _save_locked(self) -> None:
        tmp = self.path + ".tmp"
        try:
            # Sanctioned lock-held IO: concurrent Allocate handlers must
            # serialize the whole tmp+rename cycle or two writers tear
            # the same tmp file — crash consistency IS the contract here
            # (the journal is tiny; the write is bounded).
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True) 
            with open(tmp, "w", encoding="utf-8") as fh: 
                json.dump({"version": 1, "devices": self._devices}, fh) 
            os.replace(tmp, self.path) 
        except OSError as e:
            # A read-only state dir must not fail Allocate — the journal
            # is a restart hint, never the allocation's source of truth.
            LOG.warning(
                "allocation journal write failed",
                extra=log.kv(path=self.path, err=str(e)),
            )

    def record(self, resource: str, device_ids: Sequence[str]) -> None:
        """Checkpoint one granted allocation (called from the Allocate
        handler via ``on_allocate``): each device maps to the full group
        it was granted with, superseding any stale entry."""
        group = sorted(str(i) for i in device_ids)
        entry = {"resource": resource, "group": group, "ts": time.time()}
        with self._lock:
            for dev_id in group:
                self._devices[dev_id] = dict(entry)
            self._save_locked()

    def allocations(self, resource: str) -> list[tuple[str, ...]]:
        """Distinct journaled device groups for ``resource``."""
        with self._lock:
            return sorted({
                tuple(ent["group"]) for ent in self._devices.values()
                if ent.get("resource") == resource
            })

    def reconcile(self, resource: str,
                  observed_ids: set[str]) -> tuple[int, int]:
        """Startup reconcile against the OBSERVED device set: emit one
        ``alloc_reconciled`` event per journaled group whose devices all
        still exist and one ``alloc_orphaned`` per group with vanished
        devices (entry dropped). Never touches device HEALTH — health is
        the watcher's job from live probes; reconcile only restores the
        assignment map, so a restart causes zero spurious Unhealthy
        flaps in the ListAndWatch stream (tested). Returns
        ``(reconciled, orphaned)`` group counts."""
        reconciled = orphaned = 0
        for group in self.allocations(resource):
            missing = [d for d in group if d not in observed_ids]
            if missing:
                orphaned += 1
                with self._lock:
                    for dev_id in group:
                        ent = self._devices.get(dev_id)
                        if ent and tuple(ent["group"]) == group:
                            del self._devices[dev_id]
                obs.emit(
                    "plugin", "alloc_orphaned",
                    resource=resource, devices=",".join(group),
                    missing=",".join(missing),
                )
                LOG.warning(
                    "journaled allocation references vanished devices",
                    extra=log.kv(
                        resource=resource, devices=",".join(group),
                        missing=",".join(missing),
                    ),
                )
            else:
                reconciled += 1
                obs.emit(
                    "plugin", "alloc_reconciled",
                    resource=resource, devices=",".join(group),
                )
        if orphaned:
            with self._lock:
                self._save_locked()
        metrics.alloc_orphaned.labels(resource=resource).set(orphaned)
        return reconciled, orphaned


# ----- guest heartbeat aggregation ------------------------------------------


class HeartbeatAggregator:
    """Tail guest heartbeat streams, re-export per-allocation gauges.

    The allocator points every allocation's ``KATATPU_OBS_FILE`` at a
    per-allocation JSONL under ``--guest-events-dir`` (a host dir shared
    into the guests); this aggregator tails those files with
    ``obs.tail_events`` — incremental, rotation-safe, no whole-file
    re-reads per poll — extracts each ``serving_heartbeat`` /
    ``watchdog_alert`` / ``watchdog_clear``, and sets the
    ``utils.metrics.guest_*`` gauges keyed by (allocation, server): the
    workload-layer signal surfaces through the device layer, the
    per-replica occupancy/ITL feed a fleet router balances on. Standard
    library and ``obs.tail_events`` only: nothing here touches CUDA.

    A guest watchdog alert is additionally re-emitted on the DAEMON's
    own event stream as ``plugin/guest_alert`` (allocation, server,
    kind, the guest's dump path), so one host-side stream records every
    guest incident on the node.

    RESTART semantics: offsets are in-memory, and the stream files live
    on a hostPath that outlives the daemon pod — so after a restart the
    first poll re-reads whole files. That replay restores STATE (the
    gauges and active-alert sets take their last-written values, which
    is exactly what a fresh /metrics endpoint needs) but must not
    re-announce HISTORY: events stamped before the aggregator was
    constructed skip the ``_total`` counter increments, the
    ``guest_alert`` re-emission, and the warning log — a day of old
    incidents does not replay as a burst of new ones.

    GROWTH bound: the allocator arms the guest's FULL event stream
    (spans included), nothing in-guest rotates it, and the files live
    on a hostPath — so the aggregator is the rotator of last resort:
    once a file's consumed prefix exceeds ``max_stream_bytes`` (64 MiB
    default; 0 disables) it is truncated to zero. Safe against the
    writer: the guest sink appends with O_APPEND (the next write lands
    at the new EOF), a line torn by the race parses as the torn-tail
    case ``tail_events`` already skips, and the truncation-restart
    logic resets the offset — at worst a poll interval's telemetry is
    lost from a file that had already grown past the cap."""

    def __init__(self, events_dir: str, poll_interval_s: float = 5.0,
                 max_stream_bytes: int = 64 * 1024 * 1024):
        self.events_dir = events_dir
        self.poll_interval_s = poll_interval_s
        self.max_stream_bytes = int(max_stream_bytes)
        self._offsets: dict[str, int] = {}
        # (allocation, server) -> last heartbeat (staleness + debug).
        self._last: dict[tuple[str, str], dict] = {}
        self._active_alerts: dict[tuple[str, str], set] = {}
        # Replay horizon: guest events stamped before this are catch-up
        # state, not news (guest and daemon share the node clock).
        self._t0 = time.time()
        # snapshot() runs on the SIGUSR1 debug-report thread while
        # _consume inserts on the aggregator thread — same contract as
        # the manager's own _lock.
        self._lock = threading.Lock()

    def poll_once(self) -> int:
        """One tail pass over every stream file; returns the number of
        heartbeats consumed. Never raises — a torn file or vanished dir
        must not kill the daemon loop."""
        consumed = 0
        try:
            names = sorted(os.listdir(self.events_dir))
        except OSError:
            return 0
        for name in names:
            if not name.endswith(".jsonl"):
                continue
            path = os.path.join(self.events_dir, name)
            # The offset map lives next to _last/_active_alerts under
            # this class's lock discipline — touch it under the lock,
            # with the tail-file IO outside the held region.
            with self._lock:
                last_offset = self._offsets.get(path, 0)
            try:
                events, offset = obs.tail_events(path, last_offset)
            except Exception:
                continue
            if self.max_stream_bytes and offset > self.max_stream_bytes:
                # Rotator of last resort (see the class docstring): the
                # consumed prefix outgrew the cap — drop it. The guest's
                # O_APPEND writer lands its next line at the new EOF.
                try:
                    os.truncate(path, 0)
                    offset = 0
                except OSError:
                    pass
            with self._lock:
                self._offsets[path] = offset
            # Fallback allocation identity from the allocator's file
            # naming (guest_<ids>.jsonl) for events without the
            # heartbeat's own "chips" field.
            stem = name[:-len(".jsonl")]
            fallback = stem[len("guest_"):].replace("-", ",") if (
                stem.startswith("guest_")
            ) else stem
            for ev in events:
                if ev.get("kind") != "serving":
                    continue
                consumed += self._consume(ev, fallback)
        return consumed

    def _consume(self, ev: dict, fallback_alloc: str) -> int:
        name = ev.get("name")
        server = str(ev.get("server", "") or "unknown")
        alloc = str(ev.get("chips") or fallback_alloc or "unknown")
        key = (alloc, server)
        # Restart replay: state updates below always run; the "news"
        # surfaces (counters, guest_alert re-emission, warning log) only
        # for events from this daemon's lifetime.
        try:
            fresh = float(ev.get("ts") or 0.0) >= self._t0
        except (TypeError, ValueError):
            fresh = True
        if name == "serving_heartbeat":
            with self._lock:
                self._last[key] = ev
            labels = {"allocation": alloc, "server": server}
            metrics.guest_tokens_per_s.labels(**labels).set(
                float(ev.get("tokens_per_s") or 0.0)
            )
            metrics.guest_itl_p99_ms.labels(**labels).set(
                float(ev.get("itl_p99_ms") or 0.0)
            )
            metrics.guest_queue_depth.labels(**labels).set(
                float(ev.get("queued") or 0)
            )
            metrics.guest_batch_occupancy.labels(**labels).set(
                float(ev.get("batch_occupancy") or 0.0)
            )
            metrics.guest_kv_pool_occupancy.labels(**labels).set(
                float(ev.get("kv_pool_occupancy") or 0.0)
            )
            metrics.guest_kv_host_occupancy.labels(**labels).set(
                float(ev.get("kv_host_occupancy") or 0.0)
            )
            metrics.guest_last_heartbeat_ts.labels(**labels).set(
                float(ev.get("ts") or 0.0)
            )
            # Device ledger: omission-preserving — a gauge
            # child is created ONLY when the guest's heartbeat carries
            # the field, so a CPU guest (no memory_stats) or a disarmed
            # ledger exports nothing rather than a fake 0.
            if "mfu" in ev:
                metrics.guest_mfu.labels(**labels).set(
                    float(ev.get("mfu") or 0.0)
                )
            if "hbm_headroom_bytes" in ev:
                metrics.guest_hbm_headroom_bytes.labels(**labels).set(
                    float(ev.get("hbm_headroom_bytes") or 0.0)
                )
            if fresh:
                metrics.guest_heartbeats_total.labels(**labels).inc()
            return 1
        if name == "watchdog_alert":
            kind = str(ev.get("alert", "") or "unknown")
            with self._lock:
                active = self._active_alerts.setdefault(key, set())
                active.add(kind)
                n_active = len(active)
            metrics.guest_watchdog_active.labels(
                allocation=alloc, server=server
            ).set(n_active)
            if fresh:
                metrics.guest_alerts_total.labels(
                    allocation=alloc, server=server, kind=kind
                ).inc()
                obs.emit(
                    "plugin", "guest_alert",
                    allocation=alloc, server=server, alert=kind,
                    reason=ev.get("reason", ""), dump=ev.get("dump", ""),
                    trace=ev.get("trace", ""),
                )
                LOG.warning(
                    "guest watchdog alert",
                    extra=log.kv(
                        allocation=alloc, server=server, kind=kind,
                        reason=ev.get("reason", ""),
                    ),
                )
        elif name == "watchdog_clear":
            kind = str(ev.get("alert", "") or "unknown")
            with self._lock:
                active = self._active_alerts.setdefault(key, set())
                active.discard(kind)
                n_active = len(active)
            metrics.guest_watchdog_active.labels(
                allocation=alloc, server=server
            ).set(n_active)
        return 0

    def snapshot(self) -> dict:
        """Debug-report slice: last heartbeat per (allocation, server)."""
        with self._lock:
            return {
                f"{alloc}/{server}": {
                    "ts": hb.get("ts"),
                    "tokens_per_s": hb.get("tokens_per_s"),
                    "queued": hb.get("queued"),
                    "active_alerts": sorted(
                        self._active_alerts.get((alloc, server), ())
                    ),
                }
                for (alloc, server), hb in sorted(self._last.items())
            }


# ----- manager -------------------------------------------------------------


class PluginManager:
    """Owns discovery state and the fleet of per-resource plugin servers."""

    def __init__(self, cfg: Config, state_readonly: bool = False):
        self.cfg = cfg
        # True for one-shot introspection (the `status` subcommand): resolve
        # the identity without writing or clearing the daemon's state.
        self.state_readonly = state_readonly
        self._db = pciids.PciIds.load(cfg.pci_ids_path or None)
        self._lock = threading.Lock()
        self._gpu_inv: Optional[GpuInventory] = None
        self._vfio_inv: Optional[VfioInventory] = None
        self._gpu_plugin: Optional[DevicePluginServer] = None
        self._vfio_plugins: dict[tuple[str, str], DevicePluginServer] = {}
        self._watcher: Optional[HealthWatcher] = None
        self._stop = threading.Event()
        self._rescan_thread: Optional[threading.Thread] = None
        # Guest heartbeat aggregation: tails the per-allocation event
        # streams the allocator points into cfg.guest_events_dir; ""
        # disables (no env stamp, no thread).
        self._aggregator: Optional[HeartbeatAggregator] = (
            HeartbeatAggregator(
                cfg.guest_events_dir, cfg.guest_events_poll_s,
                max_stream_bytes=cfg.guest_events_max_mb * 1024 * 1024,
            )
            if cfg.guest_events_dir else None
        )
        self._aggregator_thread: Optional[threading.Thread] = None
        # Allocation-state journal in the state dir; "" disables (the
        # daemon then restarts blind, the reference behavior).
        self._journal: Optional[AllocationJournal] = (
            AllocationJournal(os.path.join(cfg.state_dir, "allocations.json"))
            if cfg.state_dir and not state_readonly else None
        )

    @property
    def aggregator(self) -> Optional[HeartbeatAggregator]:
        return self._aggregator

    # -- inventory providers (allocators call these on every Allocate) ------

    def gpu_inventory(self) -> GpuInventory:
        with self._lock:
            assert self._gpu_inv is not None
            return self._gpu_inv

    def vfio_inventory(self) -> VfioInventory:
        with self._lock:
            assert self._vfio_inv is not None
            return self._vfio_inv

    # -- lifecycle ----------------------------------------------------------

    def scan(self) -> tuple[GpuInventory, VfioInventory]:
        cfg = self.cfg
        gpu_inv = scan_gpus(cfg.sysfs_root, cfg.dev_root, cfg.proc_root,
                            pci_ids=self._db,
                            resolve_env_identity=False)  # the overlay's
        gpu_inv = self._apply_membership(gpu_inv)
        if cfg.vfio_vendors:
            vendors = () if cfg.vfio_vendors == ("*",) else cfg.vfio_vendors
            # A GPU the nvidia driver holds is not vfio-bound, so no group
            # is advertised on both paths.
            vfio_inv = scan_vfio(cfg.sysfs_root, vendors)
        else:
            vfio_inv = VfioInventory()
        with self._lock:
            self._gpu_inv = gpu_inv
            self._vfio_inv = vfio_inv
        return gpu_inv, vfio_inv

    def _apply_membership(self, gpu_inv: GpuInventory) -> GpuInventory:
        """Overlay the resolved worker identity on the scanned topology (JAX
        ``PluginManager._apply_membership`` on its autodetected path). A TPU
        accelerator type fixes a host count that a membership must match,
        and JAX refuses or rescales on a mismatch; a GPU host has no such
        type, so the membership always stands over the local GPUs
        (``num_hosts_hint=0``) and nothing it resolved is refused here. It
        is persisted only after this accepts it (``defer_save``); a
        hostname-less identity (a bare id) is never persisted."""
        cfg = self.cfg
        mem = resolve_membership(
            hostname=cfg.node_name or None,
            explicit_worker_id=cfg.worker_id,
            explicit_hostnames=cfg.worker_hostnames,
            metadata_dir=cfg.metadata_dir,
            state_dir=cfg.state_dir,
            num_hosts_hint=0,
            state_readonly=self.state_readonly,
            defer_save=True,
        )
        if mem is None:
            return gpu_inv
        if not self.state_readonly:
            persist_membership(cfg.state_dir, mem)
        topo = dataclasses.replace(gpu_inv.topology, worker_id=mem.worker_id,
                                   worker_hostnames=mem.hostnames)
        return dataclasses.replace(gpu_inv, topology=topo)

    def write_specs(self) -> list[str]:
        cfg = self.cfg
        gpu_inv, vfio_inv = self.gpu_inventory(), self.vfio_inventory()
        paths = []
        if gpu_inv.count:
            paths.append(cdi.save(build_gpu_spec(gpu_inv, cfg), cfg.cdi_dir, cfg.cdi_format))
        if vfio_inv.groups:
            paths.append(cdi.save(build_vfio_spec(vfio_inv, cfg), cfg.cdi_dir, cfg.cdi_format))
        return paths

    def gpu_allocator(self) -> GpuAllocator:
        """The GPU resource's allocation policy, over this manager's live
        inventory and the config's serving knobs."""
        cfg = self.cfg
        return GpuAllocator(
            self.gpu_inventory,
            cfg.resource_namespace,
            cfg.gpu_resource_class,
            cfg.strategies,
            dev_root=cfg.dev_root,
            revalidate=lambda chip: gpu_chip_alive(chip, cfg.sysfs_root),
            prefix_cache_tokens=cfg.prefix_cache_tokens,
            kv_pool_tokens=cfg.kv_pool_tokens,
            kv_quant=cfg.kv_quant,
            kv_layout=cfg.kv_layout,
            kv_host_tokens=cfg.kv_host_tokens,
            checkpoint_rounds=cfg.checkpoint_rounds,
            fault_schedule=cfg.faults,
            sched_policy=cfg.sched_policy,
            prefill_chunk=cfg.prefill_chunk,
            itl_slo_ms=cfg.itl_slo_ms,
            decode_steps=cfg.decode_steps,
            serving_tp=cfg.serving_tp,
            serving_tp_min=cfg.serving_tp_min,
            trace_context=cfg.trace_context,
            guest_events_dir=cfg.guest_events_dir,
            heartbeat_rounds=cfg.heartbeat_rounds,
        )

    def start(self, register: bool = True) -> None:
        cfg = self.cfg
        gpu_inv, vfio_inv = self.scan()
        LOG.info(
            "discovery complete",
            extra=log.kv(gpus=gpu_inv.count, model=gpu_inv.model_suffix,
                         vfio_models=len(vfio_inv.models)),
        )
        self.write_specs()

        # Reconcile the allocation journal against the devices this scan
        # OBSERVED, before any plugin serves, so the event stream orders
        # restart state ahead of new traffic. Reconcile never touches
        # health: vanished devices surface as alloc_orphaned events and the
        # gauge, not as Unhealthy flaps.
        if self._journal is not None:
            self._journal.reconcile(
                cfg.gpu_resource_name,
                {str(c.index) for c in gpu_inv.chips},
            )

        if self._stop.is_set():
            return
        # The GPU plugin always runs: a node without GPUs advertises an
        # empty list and picks devices up on rescan.
        self._gpu_plugin = DevicePluginServer(
            resource_name=cfg.gpu_resource_name,
            state=DeviceState(gpu_watched_devices(gpu_inv, cfg.sysfs_root)),
            allocator=self.gpu_allocator(),
            # Journal every grant at the moment it happens (the Allocate
            # handler's on_allocate hook): the restart reconcile's input.
            on_allocate=(
                (lambda ids: self._journal.record(cfg.gpu_resource_name, ids))
                if self._journal is not None else None
            ),
            socket_dir=cfg.kubelet_socket_dir,
            kubelet_socket=cfg.kubelet_socket,
            register_attempts=cfg.register_attempts,
            register_backoff_s=cfg.register_backoff_s,
        )
        # The plugin must be visible to request_stop() BEFORE start() blocks
        # in registration backoff, or a signal landing in between would miss
        # its stop event and wait out the full backoff.
        if self._stop.is_set():
            return
        self._gpu_plugin.start(register=register)

        for key, groups in vfio_inv.models.items():
            if self._stop.is_set():
                return
            self._spawn_vfio_plugin(key, groups, register)

        self._watcher = HealthWatcher(
            self.plugins(), poll_interval_s=cfg.health_poll_interval_s
        )
        self._watcher.start()
        if cfg.rescan_interval_s > 0:
            self._rescan_thread = threading.Thread(
                target=self._rescan_loop, name="rescan", daemon=True
            )
            self._rescan_thread.start()
        if self._aggregator is not None:
            self._aggregator_thread = threading.Thread(
                target=self._aggregator_loop, name="guest-heartbeats",
                daemon=True,
            )
            self._aggregator_thread.start()

    def _spawn_vfio_plugin(
        self, key: tuple[str, str], groups: list[str], register: bool
    ) -> None:
        cfg = self.cfg
        with self._lock:
            vfio_inv = self._vfio_inv
        suffix = vfio_inv.model_suffix(key, self._db) if vfio_inv else key[1]
        resource = f"{cfg.resource_namespace}/{suffix}"
        plugin = DevicePluginServer(
            resource_name=resource,
            state=DeviceState(
                vfio_watched_devices(self.vfio_inventory(), groups, cfg.dev_root)
            ),
            allocator=VfioAllocator(
                self.vfio_inventory,
                cfg.resource_namespace,
                key,
                revalidate=self._revalidate_group,
            ),
            socket_dir=cfg.kubelet_socket_dir,
            kubelet_socket=cfg.kubelet_socket,
            register_attempts=cfg.register_attempts,
            register_backoff_s=cfg.register_backoff_s,
        )
        # Visible to request_stop() before start() can block (see start()).
        # Locked: the signal-watcher thread iterates plugins() concurrently.
        with self._lock:
            self._vfio_plugins[key] = plugin
        if self._stop.is_set():
            return
        plugin.start(register=register)
        if self._watcher:
            self._watcher.add_plugin(plugin)

    def _revalidate_group(self, group: str) -> bool:
        """Live sysfs re-check at Allocate time (ref generic_device_plugin.go:
        329-338): every function of the group must still be vfio-bound and in
        the same group."""
        inv = self.vfio_inventory()
        devs = inv.groups.get(group, [])
        base = os.path.join(self.cfg.sysfs_root, "bus/pci/devices")
        for d in devs:
            devdir = os.path.join(base, d.address)
            if read_link_base(os.path.join(devdir, "iommu_group")) != group:
                return False
            if read_id_file(os.path.join(devdir, "vendor")) != d.vendor:
                return False
            if read_link_base(os.path.join(devdir, "driver")) != "vfio-pci":
                return False
        return True

    def plugins(self) -> list[DevicePluginServer]:
        out = []
        if self._gpu_plugin:
            out.append(self._gpu_plugin)
        with self._lock:  # rescan thread may be inserting concurrently
            out.extend(self._vfio_plugins.values())
        return out

    def debug_report(self) -> dict:
        """Snapshot of live manager state for observability (dumped on
        SIGUSR1 by the daemon — the pprof-handler equivalent the reference
        never registers)."""
        # Runs on the SIGUSR1 debug-dump thread while the rescan thread
        # may be swapping inventories — snapshot the references under
        # the lock, format outside it.
        with self._lock:
            gpu_inv = self._gpu_inv
            vfio_inv = self._vfio_inv
        report: dict = {
            "plugins": [
                {
                    "resource": p.resource_name,
                    "serving": p.serving,
                    "stopped": p.stopped,
                    "socket": p.socket_path,
                    "devices": [
                        {"id": d.id, "health": d.health}
                        for d in p.state.snapshot()
                    ],
                }
                for p in self.plugins()
            ],
            "watcher_alive": bool(self._watcher and self._watcher.is_alive()),
            "rescan_alive": bool(
                self._rescan_thread and self._rescan_thread.is_alive()
            ),
            "aggregator_alive": bool(
                self._aggregator_thread
                and self._aggregator_thread.is_alive()
            ),
        }
        if self._aggregator is not None:
            report["guest_heartbeats"] = self._aggregator.snapshot()
        if gpu_inv is not None:
            topo = gpu_inv.topology
            report["gpu"] = {
                "gpus": gpu_inv.count,
                "model": gpu_inv.model_suffix,
                "numa_nodes": list(topo.numa_nodes),
                "num_hosts": topo.num_hosts,
                "worker_id": topo.worker_id,
                "worker_hostnames": list(topo.worker_hostnames),
            }
        if vfio_inv is not None:
            report["vfio_models"] = {
                f"{v}:{d}": groups
                for (v, d), groups in sorted(vfio_inv.models.items())
            }
        return report

    def rescan_once(self) -> bool:
        """One re-discovery pass; returns True when anything changed."""
        old_gpu = self.gpu_inventory()
        old_vfio = self.vfio_inventory()
        gpu_inv, vfio_inv = self.scan()
        changed = False
        if self._gpu_plugin and gpu_inv.chips != old_gpu.chips:
            changed = True
            self._gpu_plugin.state.replace(
                gpu_watched_devices(gpu_inv, self.cfg.sysfs_root)
            )
        if gpu_inv.topology != old_gpu.topology:
            # The identity can resolve after start-up (a metadata agent
            # racing the DaemonSet): the spec on disk must follow it.
            changed = True
        if vfio_inv.models != old_vfio.models:
            changed = True
            # Runs on the rescan thread while gRPC handlers call
            # plugins() — snapshot the fleet under the lock (spawns
            # insert under the same lock; a key spawned below is in
            # vfio_inv.models, so the retire loop's snapshot staleness
            # is harmless).
            with self._lock:
                vfio_plugins = dict(self._vfio_plugins)
            for key, groups in vfio_inv.models.items():
                if key in vfio_plugins:
                    vfio_plugins[key].state.replace(
                        vfio_watched_devices(vfio_inv, groups, self.cfg.dev_root)
                    )
                elif not self._stop.is_set():
                    self._spawn_vfio_plugin(key, groups, register=True)
            for key in list(vfio_plugins):
                if key not in vfio_inv.models:
                    vfio_plugins[key].state.replace([])
        if changed:
            self.write_specs()
        metrics.rescans_total.labels(changed=str(changed).lower()).inc()
        return changed

    def _rescan_loop(self) -> None:
        while not self._stop.wait(self.cfg.rescan_interval_s):
            try:
                self.rescan_once()
            except Exception:
                LOG.exception("rescan failed")

    def _aggregator_loop(self) -> None:
        while not self._stop.wait(self._aggregator.poll_interval_s):
            try:
                self._aggregator.poll_once()
            except Exception:
                LOG.exception("guest heartbeat aggregation failed")

    def run_forever(self) -> None:
        """Block until stop()/request_stop() (ref ``<-stop``,
        device_plugin.go:114)."""
        self._stop.wait()

    def request_stop(self) -> None:
        """Shutdown request that takes no plugin-server locks.

        The main thread may be inside ``DevicePluginServer.start()`` holding
        the server lock (kubelet registration backoff); calling ``stop()``
        there would deadlock. This only sets events — which is also what
        wakes register's backoff waits, bounding shutdown latency — and the
        main loop falls out of :meth:`run_forever` into the real
        :meth:`stop`. Call from a normal thread (the daemon routes signals
        through a watcher thread), never directly from a signal handler.
        """
        self._stop.set()
        for plugin in self.plugins():
            plugin.request_stop()

    def stop(self) -> None:
        self._stop.set()
        if self._watcher:
            self._watcher.stop()
        for plugin in self.plugins():
            plugin.stop()
