"""Prometheus metrics of the host daemon (counterpart of
``kata_xpu_device_plugin_tpu/utils/metrics.py``).

The same names, label names and help texts as the JAX package's, made by
the port's ``obs.metrics`` factory, which writes the text exposition in
plain Python (no ``prometheus_client``). The factory is idempotent, so a
second import or a second manager in one process reuses the collectors.
:func:`serve` answers ``GET /metrics`` on a daemon thread of
``http.server``.
"""
from __future__ import annotations

from typing import Optional

from ..obs import metrics as obs_metrics

NS = "kata_tpu_device_plugin"

devices_total = obs_metrics.gauge(
    f"{NS}_devices", "Devices advertised", ["resource", "health"]
)
allocations_total = obs_metrics.counter(
    f"{NS}_allocations_total", "Allocate calls served", ["resource", "outcome"]
)
allocation_chips_total = obs_metrics.counter(
    f"{NS}_allocation_chips_total", "Chips handed out", ["resource"]
)
noncontiguous_allocations_total = obs_metrics.counter(
    f"{NS}_noncontiguous_preferred_total",
    "Preferred-allocation answers that could not keep to one NUMA node",
    ["resource"],
)
registrations_total = obs_metrics.counter(
    f"{NS}_registrations_total", "Kubelet registrations performed", ["resource"]
)
health_transitions_total = obs_metrics.counter(
    f"{NS}_health_transitions_total", "Device health transitions", ["resource", "to"]
)
rescans_total = obs_metrics.counter(
    f"{NS}_rescans_total", "Discovery rescans", ["changed"]
)
plugin_restarts_total = obs_metrics.counter(
    f"{NS}_plugin_restarts_total",
    "Plugin re-serve/re-register attempts after a socket loss "
    "(kubelet restart), by outcome",
    ["resource", "ok"],
)

# Chip-loss tolerance: how many chips the health watcher is
# currently holding out of allocation, and how many journaled allocations
# the startup reconcile found referencing vanished devices.
chips_quarantined = obs_metrics.gauge(
    f"{NS}_chips_quarantined",
    "Devices currently Unhealthy — quarantined from allocation by the "
    "health watcher",
    ["resource"],
)
alloc_orphaned = obs_metrics.gauge(
    f"{NS}_alloc_orphaned",
    "Journaled allocations whose devices were missing at the last "
    "daemon-restart reconcile (entries dropped, event emitted)",
    ["resource"],
)

# Guest heartbeat aggregation: per-allocation serving gauges
# the daemon re-exports from the guest heartbeat streams it tails
# (plugin/manager.py HeartbeatAggregator; the allocator points each
# allocation's KATATPU_OBS_FILE into --guest-events-dir). Labels:
# ``allocation`` is the granted chip set ("0,1"), ``server`` the
# in-guest GenerationServer label — several servers can share one
# allocation. These are the per-replica occupancy/ITL signals the
# ROADMAP fleet-router tier balances on.
guest_tokens_per_s = obs_metrics.gauge(
    f"{NS}_guest_tokens_per_s",
    "Decoded tokens/s over the guest's last heartbeat interval",
    ["allocation", "server"],
)
guest_itl_p99_ms = obs_metrics.gauge(
    f"{NS}_guest_itl_p99_ms",
    "Guest rolling inter-token-latency p99 (ms) at the last heartbeat",
    ["allocation", "server"],
)
guest_queue_depth = obs_metrics.gauge(
    f"{NS}_guest_queue_depth",
    "Requests queued in the guest server at the last heartbeat",
    ["allocation", "server"],
)
guest_batch_occupancy = obs_metrics.gauge(
    f"{NS}_guest_batch_occupancy",
    "Guest serving-lane occupancy (busy slots / max_batch) at the last "
    "heartbeat",
    ["allocation", "server"],
)
guest_kv_pool_occupancy = obs_metrics.gauge(
    f"{NS}_guest_kv_pool_occupancy",
    "Guest paged KV pool fill at the last heartbeat (0.0 slotted)",
    ["allocation", "server"],
)
guest_kv_host_occupancy = obs_metrics.gauge(
    f"{NS}_guest_kv_host_occupancy",
    "Guest host-RAM KV tier fill at the last heartbeat (0.0 tier off)",
    ["allocation", "server"],
)
guest_mfu = obs_metrics.gauge(
    f"{NS}_guest_mfu",
    "Guest model-FLOP utilization over the last heartbeat interval "
    "(interval FLOPs / wall x public per-chip peak x tp)",
    ["allocation", "server"],
)
guest_hbm_headroom_bytes = obs_metrics.gauge(
    f"{NS}_guest_hbm_headroom_bytes",
    "Guest device memory headroom (limit - in-use) at the last "
    "heartbeat; NO child is created for guests whose backend exposes "
    "no memory_stats (omission, never a fake 0)",
    ["allocation", "server"],
)
guest_last_heartbeat_ts = obs_metrics.gauge(
    f"{NS}_guest_last_heartbeat_ts",
    "Unix timestamp of the guest's last heartbeat (alert on "
    "time() - this for staleness)",
    ["allocation", "server"],
)
guest_watchdog_active = obs_metrics.gauge(
    f"{NS}_guest_watchdog_active",
    "Guest watchdog alert kinds currently active (0 = healthy)",
    ["allocation", "server"],
)
guest_heartbeats_total = obs_metrics.counter(
    f"{NS}_guest_heartbeats_total",
    "Guest serving heartbeats consumed by the daemon aggregator",
    ["allocation", "server"],
)
guest_alerts_total = obs_metrics.counter(
    f"{NS}_guest_alerts_total",
    "Guest watchdog alerts observed by the daemon aggregator",
    ["allocation", "server", "kind"],
)

# gRPC handler latency: one histogram, labeled by method —
# Allocate / GetPreferredAllocation / ListAndWatch_update share it.
grpc_handler_seconds = obs_metrics.histogram(
    f"{NS}_grpc_handler_seconds",
    "Device-plugin gRPC handler latency",
    ["method", "resource"],
)


def serve(port: int) -> Optional[int]:
    """Start the /metrics HTTP endpoint; 0 disables. Returns the bound
    port. Idempotent per process (delegates to obs.metrics.serve), so the
    daemon and a guest GenerationServer can both ask for the endpoint."""
    return obs_metrics.serve(port)
