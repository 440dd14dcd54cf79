"""CDI constants of the device plugin for NVIDIA GPUs (counterpart of
``kata_xpu_device_plugin_tpu/cdi/constants.py``).

The kind is NVIDIA's ``nvidia.com/gpu``, the reference's own vendor
(``cdi/spec.go:13``). A GPU's device node is ``/dev/nvidia<N>``; the
driver's shared nodes (``/dev/nvidiactl`` and the unified-memory pair)
ride the spec-level ``containerEdits`` where they exist. There is no
runtime-library mount: a guest brings its own CUDA user-space stack. Every
env name the guest reads (the ``KATA_TPU_*`` knobs, ``KATATPU_OBS*`` and
``KUBERNETES_CDI_VENDOR_CLASS``) is the JAX package's, unchanged.
"""

# The env the guest reads, under the names the port's constants.py gives
# them (one owner for each name): the multi-host identity, the trace
# context and the serving knobs. The JAX daemon's spellings of three of
# them are kept as aliases.
from ..constants import (
    ENV_CHECKPOINT_ROUNDS,
    ENV_DECODE_STEPS,
    ENV_HEARTBEAT_ROUNDS,
    ENV_ITL_SLO_MS,
    ENV_KV_HOST_TOKENS,
    ENV_KV_LAYOUT,
    ENV_KV_POOL_TOKENS,
    ENV_KV_QUANT,
    ENV_PREFILL_CHUNK,
    ENV_PREFIX_CACHE_TOKENS,
    ENV_SCHED_POLICY,
    ENV_TRACE_CTX,
    ENV_WORKER_HOSTNAMES,
    ENV_WORKER_ID,
)
from ..constants import ENV_FAULTS as ENV_FAULT_SCHEDULE
from ..constants import ENV_TP as ENV_SERVING_TP
from ..constants import ENV_TP_MIN as ENV_SERVING_TP_MIN


# CDI spec schema version this writer emits (containerd 1.7+, CRI-O 1.28+;
# the reference pins it too, cdi/spec.go:12).
CDI_VERSION = "0.6.0"

# Resource and CDI identity of NVIDIA GPUs (ref cdi/spec.go:13).
DEFAULT_VENDOR = "nvidia.com"
DEFAULT_CLASS = "gpu"
DEFAULT_KIND = f"{DEFAULT_VENDOR}/{DEFAULT_CLASS}"

# The granted devices' ids, comma-separated, under the JAX daemon's name,
# which the guest reads (guest/tp_serving.py): its length is the default
# tensor-parallel degree, the list the allocation identity of every
# serving heartbeat.
ENV_TPU_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"

# Kind of the whole-VM PCI passthrough path (vfio-bound functions of any
# vendor in the configured table), the reference's only mode.
VFIO_CLASS = "vfio"

# Annotation key prefix of container runtimes with CDI support
# (ref cdi/spec.go:14).
CDI_K8S_PREFIX = "cdi.k8s.io/"

# Kata's CDI device annotations: hot-plug this PCI function into the guest
# VM (ref pkg/device_plugin/device_plugin.go:62-68).
ANNOTATION_ATTACH_PCI = "attach-pci"
ANNOTATION_BDF = "bdf"

# Device-list strategies: how the granted devices reach the runtime
# (ref cdi/constant.go:8-12 and generic_device_plugin.go:52-71).
STRATEGY_CDI_CRI = "cdi-cri"
STRATEGY_CDI_ANNOTATIONS = "cdi-annotations"
STRATEGY_ENVVAR = "envvar"
ALL_STRATEGIES = (STRATEGY_CDI_CRI, STRATEGY_CDI_ANNOTATIONS, STRATEGY_ENVVAR)

# The CDI vendor/class a container was granted
# (ref generic_device_plugin.go:348-350).
ENV_CDI_VENDOR_CLASS = "KUBERNETES_CDI_VENDOR_CLASS"

# The driver's device nodes: one ``nvidia<N>`` a GPU (N is its minor
# number, the device id this plugin advertises), and the shared nodes every
# CUDA process opens.
GPU_NODE_PREFIX = "nvidia"
GPU_DEVICE_MAJOR = 195
SHARED_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")

# Guest telemetry uplink: the guest's JSONL event stream, switched on and
# pointed at a per-allocation file the daemon's heartbeat aggregator tails
# (the names obs/events.py reads).
ENV_OBS = "KATATPU_OBS"
ENV_OBS_FILE = "KATATPU_OBS_FILE"

# Where containerd and CRI-O read CDI spec files
# (ref pkg/device_plugin/device_plugin.go:20).
DEFAULT_CDI_DIR = "/var/run/cdi"
