"""GPU host topology and locality-aware preferred allocation (counterpart
of ``kata_xpu_device_plugin_tpu/topology``; implements what
``GetPreferredAllocation`` stubs out at generic_device_plugin.go:378-386)."""
from .host import HostTopology, runtime_env
from .preferred import Placement, chip_ids_to_indexes, choose_chips

__all__ = [
    "HostTopology",
    "runtime_env",
    "Placement",
    "chip_ids_to_indexes",
    "choose_chips",
]
