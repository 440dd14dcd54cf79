"""CDI qualified device names: ``vendor/class=device`` (counterpart of
``kata_xpu_device_plugin_tpu/cdi/names.py``).

The reference wraps the upstream CDI parser (ref ``cdi/cdi-utils.go:9-11``);
here it is native, since the qualified name is the contract between the
Allocate response and the spec file on disk.
"""
from __future__ import annotations

from .model import _NAME_RE, parse_kind


def qualified_name(vendor: str, cls: str, device: str) -> str:
    """Build ``vendor/class=device`` (ref generic_device_plugin.go:277)."""
    kind = f"{vendor}/{cls}"
    parse_kind(kind)
    if not _NAME_RE.match(device):
        raise ValueError(f"invalid CDI device id: {device!r}")
    return f"{kind}={device}"


def parse_qualified_name(name: str) -> tuple[str, str, str]:
    """Split ``vendor/class=device`` into its three parts, validating each."""
    kind, sep, device = name.partition("=")
    if not sep or not device:
        raise ValueError(f"invalid CDI qualified name: {name!r}")
    vendor, cls = parse_kind(kind)
    if not _NAME_RE.match(device):
        raise ValueError(f"invalid CDI device id in {name!r}")
    return vendor, cls, device


def is_qualified_name(name: str) -> bool:
    try:
        parse_qualified_name(name)
        return True
    except ValueError:
        return False
