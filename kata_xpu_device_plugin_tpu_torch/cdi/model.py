"""CDI spec data model (counterpart of ``kata_xpu_device_plugin_tpu/cdi/model.py``,
the same schema and validation).

A typed form of the reference's hand-rolled CDI structs (ref
``cdi/spec.go:17-83``), which model only ``deviceNodes``: ``mounts``,
``env`` and ``hooks`` inside ``containerEdits`` are first-class here.
Serialization follows the CDI 0.6.0 schema (camelCase keys, empty fields
omitted).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.:-]*$")
_VENDOR_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9.-]*[A-Za-z0-9]$")
_CLASS_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_-]*$")


def _prune(d: dict[str, Any]) -> dict[str, Any]:
    """Drop None/empty entries so emitted YAML matches the canonical CDI shape."""
    return {k: v for k, v in d.items() if v not in (None, [], {}, "")}


@dataclass
class DeviceNode:
    """A /dev node to create inside the container (CDI ``deviceNodes`` entry).

    The reference emits exactly one, ``/dev/vfio/<group>`` (ref
    device_plugin.go:71-73); the GPU path emits ``/dev/nvidia<N>`` with
    explicit type/major/minor for Kata guests where the host devtmpfs is not
    visible.
    """

    path: str
    host_path: Optional[str] = None
    type: Optional[str] = None  # "c" | "b"
    major: Optional[int] = None
    minor: Optional[int] = None
    permissions: Optional[str] = None  # e.g. "rw"
    uid: Optional[int] = None
    gid: Optional[int] = None

    def to_dict(self) -> dict[str, Any]:
        return _prune(
            {
                "path": self.path,
                "hostPath": self.host_path,
                "type": self.type,
                "major": self.major,
                "minor": self.minor,
                "permissions": self.permissions,
                "uid": self.uid,
                "gid": self.gid,
            }
        )


@dataclass
class Mount:
    """A bind mount into the container (CDI ``mounts`` entry).

    Absent from the reference model; modeled so a spec on disk with mounts
    loads and renders back unchanged.
    """

    host_path: str
    container_path: str
    options: list[str] = field(default_factory=lambda: ["ro", "nosuid", "nodev", "bind"])
    type: Optional[str] = "bind"

    def to_dict(self) -> dict[str, Any]:
        return _prune(
            {
                "hostPath": self.host_path,
                "containerPath": self.container_path,
                "options": list(self.options),
                "type": self.type,
            }
        )


@dataclass
class Hook:
    """An OCI lifecycle hook (CDI ``hooks`` entry); modeled for completeness."""

    hook_name: str
    path: str
    args: list[str] = field(default_factory=list)
    env: list[str] = field(default_factory=list)
    timeout: Optional[int] = None

    def to_dict(self) -> dict[str, Any]:
        return _prune(
            {
                "hookName": self.hook_name,
                "path": self.path,
                "args": list(self.args),
                "env": list(self.env),
                "timeout": self.timeout,
            }
        )


@dataclass
class ContainerEdits:
    """OCI spec edits applied by the runtime when a CDI device is requested
    (ref ``cdi/spec.go:26-29``, which carries only ``deviceNodes``)."""

    env: list[str] = field(default_factory=list)  # "KEY=value" strings
    device_nodes: list[DeviceNode] = field(default_factory=list)
    mounts: list[Mount] = field(default_factory=list)
    hooks: list[Hook] = field(default_factory=list)

    def add_env(self, key: str, value: str) -> "ContainerEdits":
        self.env.append(f"{key}={value}")
        return self

    def merge(self, other: "ContainerEdits") -> "ContainerEdits":
        self.env.extend(other.env)
        self.device_nodes.extend(other.device_nodes)
        self.mounts.extend(other.mounts)
        self.hooks.extend(other.hooks)
        return self

    def is_empty(self) -> bool:
        return not (self.env or self.device_nodes or self.mounts or self.hooks)

    def to_dict(self) -> dict[str, Any]:
        return _prune(
            {
                "env": list(self.env),
                "deviceNodes": [n.to_dict() for n in self.device_nodes],
                "mounts": [m.to_dict() for m in self.mounts],
                "hooks": [h.to_dict() for h in self.hooks],
            }
        )


@dataclass
class Device:
    """A named CDI device (ref ``cdi/spec.go:21-24``).

    ``name`` is the device id part of the qualified name; for GPUs this is
    the minor number of ``/dev/nvidia<N>``, stable across rescans, not the
    fragile global bus-walk counter the reference uses (device_plugin.go:175).
    """

    name: str
    container_edits: ContainerEdits = field(default_factory=ContainerEdits)
    annotations: dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not _NAME_RE.match(self.name):
            raise ValueError(f"invalid CDI device name: {self.name!r}")

    def to_dict(self) -> dict[str, Any]:
        return _prune(
            {
                "name": self.name,
                "annotations": dict(self.annotations),
                "containerEdits": self.container_edits.to_dict(),
            }
        )


@dataclass
class Spec:
    """A CDI spec file: one kind, many devices (ref ``cdi/spec.go:17-20``)."""

    kind: str
    cdi_version: str = "0.6.0"
    devices: list[Device] = field(default_factory=list)
    annotations: dict[str, str] = field(default_factory=dict)
    container_edits: ContainerEdits = field(default_factory=ContainerEdits)

    def __post_init__(self) -> None:
        parse_kind(self.kind)  # validates

    @property
    def vendor(self) -> str:
        return parse_kind(self.kind)[0]

    @property
    def cls(self) -> str:
        return parse_kind(self.kind)[1]

    def add_device(self, device: Device) -> "Spec":
        if any(d.name == device.name for d in self.devices):
            raise ValueError(f"duplicate CDI device name: {device.name!r}")
        self.devices.append(device)
        return self

    def device_names(self) -> list[str]:
        return [d.name for d in self.devices]

    def to_dict(self) -> dict[str, Any]:
        return _prune(
            {
                "cdiVersion": self.cdi_version,
                "kind": self.kind,
                "annotations": dict(self.annotations),
                "devices": [d.to_dict() for d in self.devices],
                "containerEdits": self.container_edits.to_dict(),
            }
        )

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Spec":
        """Inverse of :meth:`to_dict`; used by tests and the `status` command."""
        spec = cls(
            kind=data["kind"],
            cdi_version=data.get("cdiVersion", "0.6.0"),
            annotations=dict(data.get("annotations", {})),
            container_edits=_edits_from_dict(data.get("containerEdits", {})),
        )
        for d in data.get("devices", []):
            spec.add_device(
                Device(
                    name=d["name"],
                    annotations=dict(d.get("annotations", {})),
                    container_edits=_edits_from_dict(d.get("containerEdits", {})),
                )
            )
        return spec


def _edits_from_dict(data: dict[str, Any]) -> ContainerEdits:
    return ContainerEdits(
        env=list(data.get("env", [])),
        device_nodes=[
            DeviceNode(
                path=n["path"],
                host_path=n.get("hostPath"),
                type=n.get("type"),
                major=n.get("major"),
                minor=n.get("minor"),
                permissions=n.get("permissions"),
                uid=n.get("uid"),
                gid=n.get("gid"),
            )
            for n in data.get("deviceNodes", [])
        ],
        mounts=[
            Mount(
                host_path=m["hostPath"],
                container_path=m["containerPath"],
                options=list(m.get("options", [])),
                type=m.get("type"),
            )
            for m in data.get("mounts", [])
        ],
        hooks=[
            Hook(
                hook_name=h["hookName"],
                path=h["path"],
                args=list(h.get("args", [])),
                env=list(h.get("env", [])),
                timeout=h.get("timeout"),
            )
            for h in data.get("hooks", [])
        ],
    )


def parse_kind(kind: str) -> tuple[str, str]:
    """Split and validate a CDI kind ``vendor/class`` (e.g. ``nvidia.com/gpu``)."""
    vendor, sep, cls = kind.partition("/")
    if not sep or not _VENDOR_RE.match(vendor) or not _CLASS_RE.match(cls):
        raise ValueError(f"invalid CDI kind: {kind!r} (want vendor/class)")
    return vendor, cls
