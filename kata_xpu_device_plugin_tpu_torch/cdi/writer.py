"""Atomic CDI spec file writer/loader (counterpart of
``kata_xpu_device_plugin_tpu/cdi/writer.py``).

Fixes two reference defects (the single hardcoded spec name, and the
non-atomic writes of ``cdi/spec.go:85-127``):

- per-kind spec filenames (``<vendor>-<class>.yaml``) instead of one hardcoded
  ``cdi-vfio-xxxx`` for everything, so multiple vendors/classes coexist;
- atomic write (tempfile in the same directory + ``os.replace``) so containerd
  never reads a half-written spec.
"""
from __future__ import annotations

import json
import os
import tempfile

from .model import Spec

FORMAT_YAML = "yaml"
FORMAT_JSON = "json"


def spec_filename(kind: str, fmt: str = FORMAT_YAML) -> str:
    """``nvidia.com/gpu`` -> ``nvidia.com-gpu.yaml`` (upstream CDI convention)."""
    vendor, _, cls = kind.partition("/")
    ext = "json" if fmt == FORMAT_JSON else "yaml"
    return f"{vendor}-{cls}.{ext}"


def spec_path(spec_dir: str, kind: str, fmt: str = FORMAT_YAML) -> str:
    return os.path.join(spec_dir, spec_filename(kind, fmt))


def render(spec: Spec, fmt: str = FORMAT_YAML) -> str:
    data = spec.to_dict()
    if fmt == FORMAT_JSON:
        return json.dumps(data, indent=2, sort_keys=False) + "\n"
    if fmt == FORMAT_YAML:
        import yaml  # only the YAML format needs PyYAML

        return yaml.safe_dump(data, sort_keys=False, default_flow_style=False)
    raise ValueError(f"unknown CDI spec format: {fmt!r}")


def save(spec: Spec, spec_dir: str, fmt: str = FORMAT_YAML) -> str:
    """Write the spec atomically under ``spec_dir``; returns the final path.

    (Ref ``cdi/spec.go:85-127`` writes non-atomically with a hardcoded name and
    swallows errors with ``fmt.Println``; here failures raise.)
    """
    os.makedirs(spec_dir, mode=0o755, exist_ok=True)
    path = spec_path(spec_dir, spec.kind, fmt)
    content = render(spec, fmt)
    fd, tmp = tempfile.mkstemp(dir=spec_dir, prefix=".cdi-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load(path: str) -> Spec:
    """Read a spec file back (yaml or json); used by tests and ``status``."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        data = json.loads(text)
    else:
        import yaml  # only the YAML format needs PyYAML

        data = yaml.safe_load(text)
    return Spec.from_dict(data)


def remove(spec_dir: str, kind: str) -> None:
    """Best-effort removal of both formats of a kind's spec (shutdown path)."""
    for fmt in (FORMAT_YAML, FORMAT_JSON):
        try:
            os.unlink(spec_path(spec_dir, kind, fmt))
        except FileNotFoundError:
            pass
