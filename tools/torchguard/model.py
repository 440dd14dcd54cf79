"""torchguard's data model: the rule catalogue, the port's paths, and the
torch spellings that root each pass (counterpart of
``tools/analyze/model.py``, whose values name JAX and the JAX package).

Each rule is the twin of a JAX rule and keeps its number: TG1xx of the
jaxguard JG1xx, TL004/TL005 of the linter's JX004/JX005. The analysis is
name-based, as jaxguard's: it resolves calls through import maps and
``self.`` dispatch (the shared ``tools.analyze.graph``), not runtime
types, and the tables here anchor that approximation to the port:

- :data:`DEVICE_FN_NAMES` — callables whose results live on the card even
  where the analyzer cannot see their bodies (the port's ``prefill``,
  ``decode_chunk``, ``forward`` and friends);
- :data:`TORCH_FACTORIES` / :data:`TORCH_HOST` — ``torch.*`` calls that
  make a tensor where their ``device=`` says, or that return host values;
  every other ``torch.*`` call yields a device value when an argument is
  one (``torch.cat`` of card tensors is on the card);
- :data:`SYNC_METHODS` and friends — the calls that make the host wait
  for the card;
- :data:`HOT_ROOT_SUFFIXES` — the serving round and the trainer's ``fit``:
  everything they reach is hot. ``# torchguard: hot`` on a ``def`` line
  adds a root anywhere.
"""
from __future__ import annotations

from tools.analyze.model import (  # the JAX tool's framework-free parts
    GRPC_ENTRY_METHODS,
    LAYOUT_PARAM_NAMES,
    Finding,
)

PKG = "kata_xpu_device_plugin_tpu_torch"

ALL_RULES = {
    "TG101": "implicit host sync in a hot path outside allow_transfer "
             "(.item/.tolist/.cpu/.numpy, float/int/bool or np.asarray of "
             "a tensor, a tensor's truth test, a synchronize())",
    "TG104": "decode-graph signature hazard (a DecodeGraph/PersistentRound "
             "static that is unhashable or varies with a loop variable — "
             "one capture per value)",
    # --- TG2xx: lock discipline (tools.torchguard.concurrency) ----------
    "TG201": "lock-guarded attribute accessed without the lock on a "
             "thread-reachable path (data race)",
    "TG202": "lock acquired while holding another lock against the "
             "global lock order (deadlock hazard)",
    "TG203": "blocking call (sleep/file-IO/gRPC) made while holding a "
             "lock in a hot daemon path",
    # --- TG3xx: knob contract (tools.torchguard.contracts) --------------
    "TG301": "ENV_* knob has no matching validated Config field",
    "TG302": "ENV_* knob is never injected by an allocator/plugin site",
    "TG303": "ENV_* knob parse site converts (int/float) outside a "
             "degrade-with-event guard — malformed env would raise",
    "TG304": "ENV_* knob has no row in docs/torch_guards.md",
    # --- TG4xx: dispatch-surface contract (tools.torchguard.dispatch) ---
    "TG401": "decode-graph census violation (a DecodeGraph/PersistentRound "
             "static reachable from the serving roots draws from a device, "
             "loop-varying or unbounded source — the capture set is not "
             "closed)",
    "TG402": "graph-frozen buffer rebound (a params/arena/pool attribute a "
             "captured graph reads is reassigned on the serving path "
             "outside the graphs' rebuild — the graph keeps the old "
             "address)",
    "TG403": "placement coverage gap (a layout-switched spec helper "
             "compares against a layout outside the lattice or lets a "
             "layout fall off its end; or a synchronous host-to-card "
             "upload on the serving path outside allow_transfer)",
    "TG404": "stale pragma (an allow(RULE) whose rule no longer fires on "
             "that line — dead sanction debt)",
    # --- TL: timing windows (tools.torchguard.timing) -------------------
    "TL004": "timing loop in a script without a torch fence "
             "(torch.cuda.synchronize, Event.synchronize/elapsed_time or a "
             "host read) — it measures launches, not the card",
    "TL005": "raw perf_counter timing window in port library code (use "
             "obs.span/obs.timer)",
}

# JAX rule each torchguard rule twins (docs/torch_guards.md prints this).
JAX_TWIN = {
    "TG101": "JG101", "TG104": "JG104",
    "TG201": "JG201", "TG202": "JG202", "TG203": "JG203",
    "TG301": "JG301", "TG302": "JG302", "TG303": "JG303", "TG304": "JG304",
    "TG401": "JG401", "TG402": "JG402", "TG403": "JG403", "TG404": "JG404",
    "TL004": "JX004", "TL005": "JX005",
}

# ---------------------------------------------------------------------------
# TG1xx — device values and host syncs
# ---------------------------------------------------------------------------

DEVICE_FN_NAMES = frozenset({
    "prefill",
    "prefill_batch",
    "prefill_suffix",
    "decode",
    "decode_chunk",
    "generate",
    "forward",
    "step_fn",
    "make_train_step",
    "init_params",
    "init_kv_caches",
    "serve_decode",
})

# torch factories: a device value when ``device=`` names something other
# than the CPU; a ``*_like`` takes its argument's side.
TORCH_FACTORIES = frozenset({
    "zeros", "ones", "empty", "full", "arange", "tensor", "as_tensor",
    "rand", "randn", "randint", "randperm", "linspace", "eye",
    "empty_strided",
})
TORCH_LIKE = frozenset({
    "zeros_like", "ones_like", "empty_like", "full_like", "rand_like",
    "randn_like", "randint_like",
})
# ``torch.*`` calls whose results are host values (or no tensor at all).
TORCH_HOST = frozenset({
    "torch.from_numpy", "torch.device", "torch.dtype", "torch.Size",
    "torch.finfo", "torch.iinfo", "torch.is_tensor", "torch.numel",
    "torch.is_floating_point", "torch.no_grad", "torch.inference_mode",
    "torch.enable_grad", "torch.set_grad_enabled", "torch.Generator",
    "torch.manual_seed", "torch.get_default_dtype", "torch.set_num_threads",
    "torch.get_num_threads", "torch.compile",
})
# Namespaces under ``torch.`` that make no tensors (events, streams,
# graphs, memory stats, collectives that write in place).
TORCH_HOST_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.distributed.",
    "torch.profiler.", "torch.utils.", "torch.autograd.profiler.",
)

# Parameters that never hold a tensor, whatever a caller passes: a model
# config, and parameters annotated with a host scalar type or a config
# class (``cfg: DecoderConfig``). Context-insensitive parameter taint
# would otherwise spread from one call site that unpacks a (params, cfg)
# pair it holds as one attribute.
HOST_PARAM_NAMES = frozenset({"cfg", "config"})
HOST_ANNOTATIONS = frozenset({"int", "float", "bool", "str", "bytes"})
HOST_ANNOTATION_SUFFIX = "Config"

# torch calls that build a tensor from host data: with a ``device=`` (or a
# ``.to(device)``/``.cuda()`` straight after), a synchronous upload — the
# torch spelling of jaxguard's ``device_put`` (TG403's upload leg).
HOST_DATA_CTORS = frozenset({"torch.tensor", "torch.as_tensor",
                             "torch.from_numpy"})

# Attribute reads that return host metadata, not a device view.
NONDEVICE_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "requires_grad",
    "layout", "itemsize", "nbytes", "names", "is_leaf",
})
# Tensor methods that return host metadata.
NONDEVICE_METHODS = frozenset({
    "size", "dim", "numel", "nelement", "data_ptr", "stride",
    "element_size", "is_contiguous", "get_device", "storage_offset",
    "is_pinned", "untyped_storage",
})

# Host-sync sinks.
SYNC_BUILTINS = frozenset({"float", "int", "bool", "complex"})
SYNC_NUMPY = frozenset({
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
})
# Methods that read a tensor back to the host.
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# Calls that wait for the card whatever their receiver: a device-wide
# fence, and an Event's or a Stream's wait.
SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
SYNC_ANY_RECEIVER = frozenset({"synchronize"})

# The sanctioned region of strict mode (compat/torchapi.allow_transfer):
# a sync lexically inside one, or in a function whose every hot call site
# is inside one (at most ALLOW_DEPTH calls below the ``with``), is the
# runtime guard's own exemption.
ALLOW_LEAVES = frozenset({"allow_transfer"})
ALLOW_DEPTH = 2

HOT_ROOT_SUFFIXES = (
    "GenerationServer.step",
    "GenerationServer.run",
    ".trainer.fit",
    "Trainer.fit",
)

# ---------------------------------------------------------------------------
# TG104 / TG4xx — the decode graphs
# ---------------------------------------------------------------------------

# The serving roots of the census (the trainer captures no graph).
DISPATCH_ROOT_SUFFIXES = (
    "GenerationServer.step",
    "GenerationServer.run",
)

# A decode executable's static signature, by constructor: the arguments
# that pick one capture (guest/decode_graph.py's module doc). The rest
# (params, arena, cfg, device, the kernel callable) are what the graph
# reads, not which graph it is.
SIGNATURE_STATICS = {
    "DecodeGraph": ("batch", "steps", "table_width", "block_size",
                    "paged_len", "budget", "eos_id", "sampling", "ring"),
    "PersistentRound": ("batch", "cap", "sub_steps", "table_width",
                        "block_size", "paged_len", "eos_id"),
}
# The constructors' graph-read arguments (position, name): the buffers a
# capture freezes the addresses of.
GRAPH_READS = (
    (0, "params"),
    (1, "arena"),
)

SPEC_MODULE_PATHS = (
    f"{PKG}/guest/tp_serving.py",
    f"{PKG}/parallel/sharding.py",
    f"{PKG}/ops/decode_attn.py",
)

# ---------------------------------------------------------------------------
# TG2xx — lock discipline
# ---------------------------------------------------------------------------

# Thread entry points no ``Thread(target=...)`` spelling in reach
# reveals, matched as dotted suffixes of the flattened qualname
# ("pkg.mod.Class.method"). JAX's registry, then the port's own.
THREAD_ENTRY_REGISTRY = (
    "EventSink.emit",
    "FlightRecorder.record",
    "SLOBurnWatchdog.observe",
    "SLOBurnWatchdog.stats",
    "PluginManager.debug_report",
    "HeartbeatAggregator.snapshot",
    "AllocationJournal.record",
    # The /metrics endpoint's handler runs on http.server's thread
    # (obs/metrics.py serve: Thread(target=httpd.serve_forever)), and
    # reads the registry through a closure.
    "_Handler.do_GET",
    "MetricsRegistry.exposition",
    # __main__'s signal watcher and its SIGUSR1 dump thread are nested
    # functions the resolver cannot chase from their Thread() sites.
    "main._signal_watcher",
    "main._signal_watcher._dump",
    # The kernels' build (ops/_build.py's module lock) runs on whichever
    # thread launches a kernel first: the serving loop, a fence worker,
    # a training step.
    "ops._build.build",
    "ops._build.load",
)

# ---------------------------------------------------------------------------
# TG3xx — knob contract
# ---------------------------------------------------------------------------

KNOB_CONSTANTS_PATH = f"{PKG}/constants.py"
KNOB_CONFIG_PATH = f"{PKG}/config.py"
KNOB_DOC_PATH = "docs/torch_guards.md"
KNOB_INJECTION_PREFIXES = (f"{PKG}/plugin/",)

# Identity envs the daemon injects that are not operator knobs (JAX's
# KNOB_EXEMPT: TPU_WORKER_*): exempt from TG301-TG304.
KNOB_EXEMPT = frozenset({
    "ENV_WORKER_HOSTNAMES",
    "ENV_WORKER_ID",
})

# Guest-local knobs: the JAX package defines these beside the code that
# reads them (compat/jaxapi.py, obs/watchdog.py, guest/resilience.py,
# guest/serving.py, models/quant), outside its knob catalogue, so JG301/
# JG302 never see them; the port keeps every knob in constants.py. The
# daemon neither sets nor injects them: TG301/TG302 skip them, TG303/
# TG304 hold them like the rest.
KNOB_GUEST_LOCAL = frozenset({
    "ENV_DECODE_ATTN", "ENV_DECODE_KERNEL", "ENV_FUSED", "ENV_PERSISTENT",
    "ENV_SPEC_OPT_IN", "ENV_DEVLEDGER", "ENV_STRICT", "ENV_FAULTS_SEED",
    "ENV_FENCE_TIMEOUT", "ENV_MAINTENANCE_FILE", "ENV_QUARANTINE_K",
    "ENV_RECOVERY_BACKOFF_S", "ENV_RECOVERY", "ENV_DEGRADED", "ENV_W8A8",
    "ENV_WATCHDOG", "ENV_WATCHDOG_BURN", "ENV_WATCHDOG_WINDOW",
    "ENV_WATCHDOG_SUSTAIN", "ENV_WATCHDOG_CLEAR",
    "ENV_WATCHDOG_PREEMPT_STORM", "ENV_WATCHDOG_RECOVERY_STORM",
    "ENV_WATCHDOG_PROFILE_DIR", "ENV_WATCHDOG_PROFILE_STEPS",
    "ENV_WATCHDOG_GAP_RATIO", "ENV_WATCHDOG_GAP_MIN_MS",
    "ENV_WATCHDOG_HEADROOM_FLOOR",
})

# Config fields off the value-derived convention (strip "KATA_TPU_",
# lowercase): JAX's overrides under the port's constant names.
KNOB_FIELD_OVERRIDES = {
    "ENV_TP": "serving_tp",
    "ENV_TP_MIN": "serving_tp_min",
    "ENV_TRACE_CTX": "trace_context",
    "ENV_HEARTBEAT_ROUNDS": "heartbeat_rounds",
}

# ---------------------------------------------------------------------------
# TL — timing windows
# ---------------------------------------------------------------------------

TIMER_CALLS = frozenset({"perf_counter", "monotonic", "time"})
# Calls that fence the card before a timer is read.
TIMING_FENCES = frozenset({
    "synchronize", "elapsed_time", "item", "tolist", "cpu", "numpy",
})

__all__ = ["ALL_RULES", "Finding", "GRPC_ENTRY_METHODS", "JAX_TWIN",
           "LAYOUT_PARAM_NAMES", "PKG"]
