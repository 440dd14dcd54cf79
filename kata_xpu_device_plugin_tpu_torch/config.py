"""Configuration of the host daemon for NVIDIA GPUs (counterpart of
``kata_xpu_device_plugin_tpu/config.py``).

The reference hardcodes its vendor id, CDI dir, sysfs path, pci.ids path,
resource namespace, socket naming, strategies and spec filename; each is a
flag or an env here, and tests inject temp roots through the same object.

Precedence: CLI flag > environment (``KATA_TPU_<FIELD>``) > default.

Against the JAX package's flags: ``--gpu-resource-class`` takes the place
of ``--tpu-resource-class`` and ``--proc-root`` is new (the driver's
procfs names each GPU's minor); ``--accelerator-type``,
``--libtpu-host-path`` and ``--compile-cache-dir`` are TPU- or XLA-only and
dropped, as are the TPU multislice flags (``--num-slices``, ``--slice-id``,
``--megascale-coordinator``), whose ``MEGASCALE_*`` env only libtpu reads.
The membership flags ``--worker-id``, ``--worker-hostnames``,
``--node-name`` and ``--metadata-dir`` are the JAX package's: the manager
resolves them through :mod:`.multihost` into the spec's ``TPU_WORKER_*``.
"""
from __future__ import annotations

import argparse
import os
from dataclasses import MISSING, dataclass, fields

from .cdi import constants as C

# Kubelet filesystem contract (also in plugin.api.glue; repeated here so
# config does not import grpc).
_KUBELET_SOCKET_DIR = "/var/lib/kubelet/device-plugins"
_POD_RESOURCES_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"


@dataclass
class Config:
    # Host interface roots (ref device_plugin.go:36-37 package vars).
    sysfs_root: str = "/sys"
    dev_root: str = "/dev"
    proc_root: str = "/proc"
    pci_ids_path: str = ""  # "" = search ladder (system paths, then bundled)

    # CDI (ref device_plugin.go:20, cdi/spec.go:12-14).
    cdi_dir: str = C.DEFAULT_CDI_DIR
    cdi_format: str = "yaml"  # yaml | json
    resource_namespace: str = C.DEFAULT_VENDOR  # CDI vendor + resource prefix
    gpu_resource_class: str = C.DEFAULT_CLASS

    # Device-list strategies (ref generic_device_plugin.go:58-66 hardcodes
    # cdi-cri on, cdi-annotations off).
    strategies: tuple[str, ...] = (C.STRATEGY_CDI_CRI,)

    # Kubelet endpoints (ref generic_device_plugin.go:76, pluginapi constants).
    kubelet_socket_dir: str = _KUBELET_SOCKET_DIR
    kubelet_socket: str = ""  # "" = <kubelet_socket_dir>/kubelet.sock
    pod_resources_socket: str = _POD_RESOURCES_SOCKET

    kata_annotations: bool = True  # attach-pci/bdf hints for Kata hot-plug

    # Multi-host identity, resolved through the multihost ladder (flags,
    # TPU_WORKER_* env, metadata dir, derived from the hostname order); a
    # standalone host needs none of them.
    worker_id: int = -1  # -1 = auto
    worker_hostnames: tuple[str, ...] = ()
    # Name to match against worker lists. In a DaemonSet without
    # hostNetwork the pod's hostname is the pod name, never the node's:
    # project spec.nodeName through the downward API into
    # KATA_TPU_NODE_NAME.
    node_name: str = ""
    metadata_dir: str = ""  # dir of metadata attribute files
    # Persisted daemon state (the worker identity and the allocation
    # journal); "" disables.
    state_dir: str = "/var/run/kata-tpu"

    # Generalized VFIO path. Empty vendor tuple = VFIO discovery disabled;
    # ("*",) = all vendors (the reference pins exactly one vendor, 10de).
    vfio_vendors: tuple[str, ...] = ()

    # Periodic re-discovery and health polling (the reference has neither).
    rescan_interval_s: float = 30.0
    health_poll_interval_s: float = 5.0

    # Observability: the daemon's /metrics port (0 disables), logging, its
    # own JSONL event stream and a profiler dump dir ("" disables each).
    metrics_port: int = 9400
    log_level: str = "info"
    log_format: str = "text"
    obs_events_file: str = ""
    obs_profile_dir: str = ""

    # Serving defaults handed to every GPU allocation's guest through the
    # Allocate response's env (constants.ENV_*); 0 or "" injects nothing
    # and leaves the guest's own default. Each is read by the guest's
    # GenerationServer when the caller passes no explicit argument, and a
    # malformed value degrades in-guest with an event.
    prefix_cache_tokens: int = 0  # KATA_TPU_PREFIX_CACHE_TOKENS
    kv_pool_tokens: int = 0  # KATA_TPU_KV_POOL_TOKENS: the paged pool
    kv_layout: str = ""  # KATA_TPU_KV_LAYOUT: heads | blocks
    kv_host_tokens: int = 0  # KATA_TPU_KV_HOST_TOKENS: host-RAM KV tier
    kv_quant: str = ""  # KATA_TPU_KV_QUANT: int8 | bf16
    checkpoint_rounds: int = 0  # KATA_TPU_CHECKPOINT_ROUNDS
    faults: str = ""  # KATA_TPU_FAULTS: a chaos-testing fault schedule
    sched_policy: str = ""  # KATA_TPU_SCHED_POLICY: fifo_batch | slo_chunked
    prefill_chunk: int = 0  # KATA_TPU_PREFILL_CHUNK
    itl_slo_ms: float = 0.0  # KATA_TPU_ITL_SLO_MS
    decode_steps: int = 0  # KATA_TPU_DECODE_STEPS (injected when > 1)
    serving_tp: int = 0  # KATA_TPU_TP: the tensor-parallel degree
    serving_tp_min: int = 0  # KATA_TPU_TP_MIN: the shrink ladder's floor

    # Guest telemetry uplink: when set, every GPU Allocate switches the
    # guest's JSONL event stream on (KATATPU_OBS=1) and points
    # KATATPU_OBS_FILE at a per-allocation file under this directory (a
    # host path shared with the guests); the daemon's heartbeat aggregator
    # tails those files and re-exports per-allocation serving gauges on
    # /metrics. "" disables both.
    guest_events_dir: str = ""
    guest_events_poll_s: float = 5.0  # seconds between tail passes
    # Per-stream growth cap in MiB: the aggregator truncates a guest event
    # file once its consumed prefix exceeds this (0 disables).
    guest_events_max_mb: int = 64
    heartbeat_rounds: int = 0  # KATA_TPU_HEARTBEAT_ROUNDS when > 0

    # Each Allocate stamps its span's trace id into KATA_TPU_TRACE_CTX, so
    # the guest's spans and events join the daemon's allocation trace.
    trace_context: bool = True

    # Kubelet registration retry policy: attempts x capped exponential
    # backoff (with jitter) before a registration_exhausted event.
    register_attempts: int = 5
    register_backoff_s: float = 1.0

    def __post_init__(self) -> None:
        if not self.kubelet_socket:
            self.kubelet_socket = os.path.join(self.kubelet_socket_dir, "kubelet.sock")
        for s in self.strategies:
            if s not in C.ALL_STRATEGIES:
                raise ValueError(f"unknown device-list strategy: {s!r}")
        if self.cdi_format not in ("yaml", "json"):
            raise ValueError(f"cdi-format must be yaml or json, got {self.cdi_format!r}")
        choices = (("sched-policy", self.sched_policy, ("fifo_batch", "slo_chunked")),
                   ("kv-quant", self.kv_quant, ("int8", "bf16")),
                   ("kv-layout", self.kv_layout, ("heads", "blocks")))
        for flag, value, allowed in choices:
            if value not in ("", *allowed):
                raise ValueError(
                    f"{flag} must be {' or '.join(allowed)}, got {value!r}")
        for flag, value in (("kv-host-tokens", self.kv_host_tokens),
                            ("prefill-chunk", self.prefill_chunk),
                            ("itl-slo-ms", self.itl_slo_ms),
                            ("decode-steps", self.decode_steps),
                            ("serving-tp", self.serving_tp),
                            ("serving-tp-min", self.serving_tp_min),
                            ("guest-events-max-mb", self.guest_events_max_mb),
                            ("heartbeat-rounds", self.heartbeat_rounds),
                            ("register-backoff-s", self.register_backoff_s)):
            if value < 0:
                raise ValueError(f"{flag} must be >= 0, got {value}")
        if self.serving_tp and self.serving_tp_min > self.serving_tp:
            raise ValueError(
                f"serving-tp-min {self.serving_tp_min} exceeds serving-tp "
                f"{self.serving_tp} — the shrink ladder could never start"
            )
        if self.guest_events_poll_s <= 0:
            raise ValueError(
                f"guest-events-poll-s must be > 0, got "
                f"{self.guest_events_poll_s}"
            )
        if self.register_attempts < 1:
            raise ValueError(
                f"register-attempts must be >= 1, got {self.register_attempts}"
            )
        if len(set(self.worker_hostnames)) != len(self.worker_hostnames):
            raise ValueError("worker-hostnames contains duplicates")
        if self.worker_id >= 0 and self.worker_hostnames and (
            self.worker_id >= len(self.worker_hostnames)
        ):
            raise ValueError(
                f"worker-id {self.worker_id} out of range for "
                f"{len(self.worker_hostnames)} worker-hostnames"
            )

    @property
    def gpu_resource_name(self) -> str:
        """The extended resource advertised for GPUs (``nvidia.com/gpu``)."""
        return f"{self.resource_namespace}/{self.gpu_resource_class}"

    @property
    def gpu_cdi_kind(self) -> str:
        return f"{self.resource_namespace}/{self.gpu_resource_class}"

    @property
    def vfio_cdi_kind(self) -> str:
        return f"{self.resource_namespace}/{C.VFIO_CLASS}"


_ENV_PREFIX = "KATA_TPU_"


def _flag(name: str) -> str:
    return "--" + name.replace("_", "-")


def add_flags(parser: argparse.ArgumentParser) -> None:
    for f in fields(Config):
        env_val = os.environ.get(_ENV_PREFIX + f.name.upper())
        # The raw field default, not a Config(): __post_init__ derives
        # kubelet_socket from kubelet_socket_dir, and a derived default would
        # pin the flag even when the user moves the directory.
        default = f.default if f.default is not MISSING else f.default_factory()  # type: ignore[misc]
        if f.type in ("tuple[str, ...]",):
            default = ",".join(default) if env_val is None else env_val
            parser.add_argument(_flag(f.name), default=default, help=f"csv ({f.name})")
        elif isinstance(default, bool):
            val = default if env_val is None else env_val.lower() in ("1", "true", "yes")
            parser.add_argument(
                _flag(f.name), default=val, action=argparse.BooleanOptionalAction
            )
        elif isinstance(default, (int, float)) and not isinstance(default, bool):
            typ = type(default)
            parser.add_argument(
                _flag(f.name), type=typ, default=typ(env_val) if env_val else default
            )
        else:
            parser.add_argument(_flag(f.name), default=env_val if env_val is not None else default)


def from_args(args: argparse.Namespace) -> Config:
    kwargs = {}
    for f in fields(Config):
        val = getattr(args, f.name)
        if f.type == "tuple[str, ...]":
            val = tuple(v for v in str(val).split(",") if v) if val else ()
        kwargs[f.name] = val
    return Config(**kwargs)
