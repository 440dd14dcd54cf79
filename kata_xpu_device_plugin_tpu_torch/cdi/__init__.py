"""CDI spec model + writer (counterpart of ``kata_xpu_device_plugin_tpu/cdi``
and of the reference's ``cdi/`` package)."""
from . import constants
from .model import ContainerEdits, Device, DeviceNode, Hook, Mount, Spec, parse_kind
from .names import is_qualified_name, parse_qualified_name, qualified_name
from .writer import FORMAT_JSON, FORMAT_YAML, load, remove, render, save, spec_filename, spec_path

__all__ = [
    "constants",
    "ContainerEdits",
    "Device",
    "DeviceNode",
    "Hook",
    "Mount",
    "Spec",
    "parse_kind",
    "qualified_name",
    "parse_qualified_name",
    "is_qualified_name",
    "FORMAT_JSON",
    "FORMAT_YAML",
    "render",
    "save",
    "load",
    "remove",
    "spec_filename",
    "spec_path",
]
