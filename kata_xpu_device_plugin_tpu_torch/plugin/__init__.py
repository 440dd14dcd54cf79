"""Kubelet device-plugin layer for NVIDIA GPUs: gRPC server, allocation
policies, health watching, and the discovery→CDI→serve orchestration
(counterpart of ``kata_xpu_device_plugin_tpu/plugin`` and of the
reference's ``pkg/device_plugin``)."""
from .allocators import GpuAllocator, VfioAllocator
from .health import HealthWatcher
from .manager import (
    AllocationJournal,
    HeartbeatAggregator,
    PluginManager,
    build_gpu_spec,
    build_vfio_spec,
)
from .server import AllocationError, DevicePluginServer, DeviceState, WatchedDevice

__all__ = [
    "AllocationJournal",
    "GpuAllocator",
    "HeartbeatAggregator",
    "VfioAllocator",
    "HealthWatcher",
    "PluginManager",
    "build_gpu_spec",
    "build_vfio_spec",
    "AllocationError",
    "DevicePluginServer",
    "DeviceState",
    "WatchedDevice",
]
