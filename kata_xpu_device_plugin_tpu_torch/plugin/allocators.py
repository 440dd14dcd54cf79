"""Resource-specific allocation policies (counterpart of
``kata_xpu_device_plugin_tpu/plugin/allocators.py``).

Split out of the server (the reference fuses policy into the gRPC handlers,
``generic_device_plugin.go:274-355``): the server validates ids and streams
health; allocators decide CDI names, env and placement.

Env contract with the guest: the host's static identity (worker id and
hostnames) rides the CDI spec's spec-level ``containerEdits``, identical for
every pod on the host; the per-allocation env (the granted GPUs, the trace
context, the guest's event stream and the serving knobs) rides the
AllocateResponse, merged (the reference overwrites the env map it just
built).
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

from .. import obs
from .. import topology as topo_mod
from ..cdi import constants as C
from ..cdi import qualified_name
from ..discovery.gpu import GpuInventory
from ..discovery.vfio import VfioInventory
from ..topology import runtime_env
from ..utils import log, metrics
from .api import deviceplugin_pb2 as pb
from .server import AllocationError

LOG = log.get("alloc")


class GpuAllocator:
    """Allocation policy for ``nvidia.com/gpu``: device ids are the GPUs'
    minor numbers; preferred keeps to one NUMA node and PCI switch; Allocate
    re-validates each GPU against the live host (the reference's sysfs
    re-validation at generic_device_plugin.go:329-338, done against the
    GPU's node and driver binding)."""

    def __init__(
        self,
        inventory: Callable[[], GpuInventory],
        vendor: str,
        cls: str,
        strategies: Sequence[str] = (C.STRATEGY_CDI_CRI,),
        dev_root: str = "/dev",
        revalidate: Optional[Callable[[object], bool]] = None,
        prefix_cache_tokens: int = 0,
        kv_pool_tokens: int = 0,
        kv_quant: str = "",
        kv_layout: str = "",
        kv_host_tokens: int = 0,
        checkpoint_rounds: int = 0,
        fault_schedule: str = "",
        sched_policy: str = "",
        prefill_chunk: int = 0,
        itl_slo_ms: float = 0.0,
        decode_steps: int = 0,
        serving_tp: int = 0,
        serving_tp_min: int = 0,
        trace_context: bool = True,
        guest_events_dir: str = "",
        heartbeat_rounds: int = 0,
    ):
        self._inventory = inventory
        self._vendor = vendor
        self._cls = cls
        self._strategies = tuple(strategies)
        self._resource = f"{vendor}/{cls}"
        self._dev_root = dev_root
        # The serving knobs (Config's fields of the same names): each rides
        # the response's env when set, and the guest's GenerationServer
        # reads it when the caller passes no explicit argument.
        self._knobs = (
            (C.ENV_PREFIX_CACHE_TOKENS, int(prefix_cache_tokens), 0),
            (C.ENV_KV_POOL_TOKENS, int(kv_pool_tokens), 0),
            (C.ENV_KV_QUANT, str(kv_quant), None),
            (C.ENV_KV_LAYOUT, str(kv_layout), None),
            (C.ENV_KV_HOST_TOKENS, int(kv_host_tokens), 0),
            (C.ENV_CHECKPOINT_ROUNDS, int(checkpoint_rounds), 0),
            (C.ENV_FAULT_SCHEDULE, str(fault_schedule), None),
            (C.ENV_SCHED_POLICY, str(sched_policy), None),
            (C.ENV_PREFILL_CHUNK, int(prefill_chunk), 0),
            (C.ENV_ITL_SLO_MS, float(itl_slo_ms), 0),
            (C.ENV_DECODE_STEPS, int(decode_steps), 1),
            (C.ENV_SERVING_TP_MIN, int(serving_tp_min), 0),
            (C.ENV_SERVING_TP, int(serving_tp), 0),
        )
        self._serving_tp = int(serving_tp)
        # Each Allocate stamps its own span's trace id (or a fresh one when
        # no span is open) into KATA_TPU_TRACE_CTX.
        self._trace_context = bool(trace_context)
        # Guest telemetry uplink: each Allocate switches the guest's JSONL
        # event stream on and points it at a per-allocation file under the
        # shared dir, which the manager's heartbeat aggregator tails.
        self._guest_events_dir = str(guest_events_dir)
        self._heartbeat_rounds = int(heartbeat_rounds)
        # Driver-level liveness from the manager (``manager.gpu_chip_alive``:
        # node_alive over the node and driver-binding pair the health
        # watcher tracks); the existence-only fallback serves direct
        # construction in tests.
        self._revalidate = revalidate or (lambda chip: os.path.exists(chip.dev_path))

    def allocate(self, device_ids: Sequence[str]) -> pb.ContainerAllocateResponse:
        inv = self._inventory()
        chips = []
        for dev_id in device_ids:
            if not dev_id.isdigit():
                raise AllocationError(f"malformed GPU device id {dev_id!r}")
            try:
                chip = inv.chip(int(dev_id))
            except KeyError:
                raise AllocationError(f"GPU {dev_id} not in current inventory")
            if not self._revalidate(chip):
                raise AllocationError(f"GPU {dev_id} failed liveness re-validation")
            chips.append(chip)

        resp = pb.ContainerAllocateResponse()
        names = [qualified_name(self._vendor, self._cls, str(c.index)) for c in chips]
        if C.STRATEGY_CDI_CRI in self._strategies:
            for name in names:
                resp.cdi_devices.add(name=name)
        if C.STRATEGY_CDI_ANNOTATIONS in self._strategies:
            resp.annotations[f"{C.CDI_K8S_PREFIX}{self._vendor}_{self._cls}"] = ",".join(names)
        if C.STRATEGY_ENVVAR in self._strategies:
            # Direct injection for runtimes without CDI: everything the CDI
            # spec's containerEdits carry (each GPU's node, the driver's
            # shared nodes, the host's static env) rides the response.
            for c in chips:
                resp.devices.add(
                    container_path=c.dev_path, host_path=c.dev_path, permissions="rw"
                )
            for name in C.SHARED_NODES:
                path = os.path.join(self._dev_root, name)
                if os.path.exists(path):
                    resp.devices.add(
                        container_path=path, host_path=path, permissions="rw")
            for key, val in runtime_env(inv.topology).items():
                resp.envs[key] = val
        resp.envs[C.ENV_CDI_VENDOR_CLASS] = self._resource
        resp.envs[C.ENV_TPU_VISIBLE_CHIPS] = ",".join(str(c.index) for c in chips)
        if self._trace_context:
            # The daemon-to-guest trace handoff: inside the gRPC handler this
            # is the plugin.Allocate span's trace id, so everything the guest
            # emits under it joins the allocation's trace; a direct call with
            # no open span mints a fresh id, still one join key for every
            # workload of the allocation.
            resp.envs[C.ENV_TRACE_CTX] = (
                obs.current_trace_id() or obs.new_trace()
            )
        if self._guest_events_dir:
            # The file name carries the granted GPUs, the identity the
            # journal records, so the aggregator can label a stream that
            # ends before its first heartbeat.
            ident = "-".join(str(c.index) for c in chips)
            resp.envs[C.ENV_OBS] = "1"
            resp.envs[C.ENV_OBS_FILE] = os.path.join(
                self._guest_events_dir, f"guest_{ident}.jsonl"
            )
        if self._heartbeat_rounds > 0:
            resp.envs[C.ENV_HEARTBEAT_ROUNDS] = str(self._heartbeat_rounds)
        for key, value, unset in self._knobs:
            if value and (unset is None or value > unset):
                resp.envs[key] = str(value)
        if self._serving_tp > len(chips):
            # The guest degrades to tp=1 with a tp_disabled event; say so
            # host-side too, before anyone reads guest event streams.
            LOG.warning(
                "serving-tp exceeds the granted GPU count; guest "
                "will degrade to single-GPU serving",
                extra=log.kv(serving_tp=self._serving_tp, gpus=len(chips)),
            )
        return resp

    def preferred(
        self, available: Sequence[str], must_include: Sequence[str], size: int
    ) -> list[str]:
        inv = self._inventory()
        placement = topo_mod.choose_chips(
            inv.chips,
            topo_mod.chip_ids_to_indexes(available),
            size,
            topo_mod.chip_ids_to_indexes(must_include),
        )
        if not placement.contiguous:
            metrics.noncontiguous_allocations_total.labels(resource=self._resource).inc()
            LOG.warning(
                "no single-NUMA-node placement possible",
                extra=log.kv(available=",".join(available), size=size),
            )
        return [str(c) for c in placement.chips]


class VfioAllocator:
    """Allocation policy for whole-VM passthrough: device ids are IOMMU group
    ids (the reference's model, kept for the generalized path)."""

    def __init__(
        self,
        inventory: Callable[[], VfioInventory],
        vendor: str,
        model_key: tuple[str, str],
        revalidate: Optional[Callable[[str], bool]] = None,
    ):
        self._inventory = inventory
        self._vendor = vendor
        self._model_key = model_key
        self._revalidate = revalidate

    def allocate(self, device_ids: Sequence[str]) -> pb.ContainerAllocateResponse:
        inv = self._inventory()
        resp = pb.ContainerAllocateResponse()
        names = []
        for group in device_ids:
            devs = inv.groups.get(group)
            if not devs:
                raise AllocationError(f"IOMMU group {group} not in current inventory")
            if self._revalidate and not self._revalidate(group):
                raise AllocationError(f"IOMMU group {group} failed sysfs re-validation")
            names.append(qualified_name(self._vendor, C.VFIO_CLASS, group))
        for name in names:
            resp.cdi_devices.add(name=name)
        resp.envs[C.ENV_CDI_VENDOR_CLASS] = f"{self._vendor}/{C.VFIO_CLASS}"
        return resp

    def preferred(
        self, available: Sequence[str], must_include: Sequence[str], size: int
    ) -> list[str]:
        """NUMA-aware pick (generalizes the ref's nil stub at
        generic_device_plugin.go:378-386): groups are functionally
        interchangeable, but cross-socket DMA costs — so fill from the NUMA
        node that (a) already hosts the must-include groups and (b) can
        satisfy the most of the request, before spilling to other nodes."""
        inv = self._inventory()

        def node_of(group: str):
            devs = inv.groups.get(group) or []
            nodes = {d.numa_node for d in devs if d.numa_node is not None}
            return nodes.pop() if len(nodes) == 1 else None

        picked = list(must_include)
        rest = [a for a in available if a not in must_include]
        by_node: dict[object, list[str]] = {}
        for g in rest:
            by_node.setdefault(node_of(g), []).append(g)
        pinned = {node_of(g) for g in must_include} - {None}
        # Nodes the request is already on first, then by how much of the
        # remainder they can satisfy; unknown-NUMA groups last.
        order = sorted(
            by_node,
            key=lambda n: (n not in pinned, n is None, -len(by_node[n])),
        )
        for node in order:
            picked.extend(by_node[node])
        return picked[:size]
