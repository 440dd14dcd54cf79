"""Environment knobs the PyTorch/CUDA serving path reads.

The names are the ones the device plugin injects into a guest (the JAX
package's ``cdi/constants.py`` holds the daemon side); this package keeps
its own copy so it imports nothing of the JAX package.
"""
from __future__ import annotations

# KV cache dtype for GenerationServer: "int8" (the default) or "bf16".
# Anything else degrades to the default; an explicit kv_quant= wins.
ENV_KV_QUANT = "KATA_TPU_KV_QUANT"
DEFAULT_KV_QUANT = "int8"

# Decode-attention backend override: one of ops.attention.DECODE_ATTN_BACKENDS.
# Unknown values degrade to the automatic choice (the kernel on CUDA, the
# plain version on the CPU); an explicit decode_attn= argument wins.
ENV_DECODE_ATTN = "KATA_TPU_DECODE_ATTN"

# Opt-in for the lock-step dense decode kernel in generate(): "1" turns it
# on (ops.attention.decode_eligible); anything else leaves generate on the
# paged kernel over the slotted re-view.
ENV_DECODE_KERNEL = "KATA_TPU_DECODE_KERNEL"

# Paged KV pool size in tokens for GenerationServer; 0 or unset means the
# slotted arena. A malformed value degrades to slotted; an explicit
# kv_pool_tokens= argument wins.
ENV_KV_POOL_TOKENS = "KATA_TPU_KV_POOL_TOKENS"

# Multi-step decode for GenerationServer: K chunks of ``chunk`` steps per
# host dispatch, with lanes frozen on the device at their budget or eos. A
# malformed or < 1 value degrades to K = 1; an explicit decode_steps=
# argument wins, and one < 1 raises.
ENV_DECODE_STEPS = "KATA_TPU_DECODE_STEPS"

# Admission policy for GenerationServer: "fifo_batch" (the default) or
# "slo_chunked" (guest/scheduler.py). An unknown env value degrades to
# fifo_batch; an explicit unknown sched_policy= raises.
ENV_SCHED_POLICY = "KATA_TPU_SCHED_POLICY"

# Prefill slice width of a chunked admission in tokens (slo_chunked). A
# malformed or < 1 env value degrades to the default; an explicit
# prefill_chunk= < 1 raises.
ENV_PREFILL_CHUNK = "KATA_TPU_PREFILL_CHUNK"

# Per-token inter-token-latency deadline in ms that slo_chunked steers
# admission by. A malformed env value degrades to the default.
ENV_ITL_SLO_MS = "KATA_TPU_ITL_SLO_MS"

# Fused prefill+decode dispatch under slo_chunked: on by default, "0"
# turns it off, anything but "0"/"1" degrades to the default; an explicit
# fused=True without slo_chunked raises.
ENV_FUSED = "KATA_TPU_FUSED"

# Persistent decode rounds: "1" turns them on. Anything but "0"/"1"
# degrades to off, as does a server that samples; an explicit
# persistent=True on a sampling server raises.
ENV_PERSISTENT = "KATA_TPU_PERSISTENT"

# Speculative decoding's opt-in: "1" arms a GenerationServer built with
# speculative_k > 0; otherwise it degrades to plain decoding with a
# ``spec_disabled`` event. An explicit spec_opt_in= wins.
ENV_SPEC_OPT_IN = "KATA_TPU_SPEC"

# Shared-prefix KV cache for GenerationServer: a slotted server's store of
# that many tokens, or, on a paged server, any value > 0 turns on the
# prefix tier inside the pool. A malformed or negative value degrades to
# 0, as does the env value on a server without prefill_buckets; an
# explicit prefix_cache_tokens= without prefill_buckets raises.
ENV_PREFIX_CACHE_TOKENS = "KATA_TPU_PREFIX_CACHE_TOKENS"

# Host-RAM KV tier below a paged pool, in tokens: demoted prefix segments
# and preempted sessions' spills. A malformed or negative value degrades
# to 0, as does the env value on a slotted server; an explicit
# kv_host_tokens= < 0, or > 0 on a slotted server, raises.
ENV_KV_HOST_TOKENS = "KATA_TPU_KV_HOST_TOKENS"

# Tensor-parallel degree of GenerationServer (the daemon's override): "0" or
# "1" pins one shard; a malformed or negative value degrades to the degree
# the topology env gives (guest/tp_serving.py tp_from_env); a degree above
# the devices present degrades to 1. An explicit tp= argument wins.
ENV_TP = "KATA_TPU_TP"

# Paged pool layout under tensor parallelism: "heads" (the KV-head axis
# splits where the KV heads divide the degree, else the pool replicates) or
# "blocks" (the pool's token axis splits into per-shard sub-pools). An
# unknown value degrades to "heads", as does "blocks" on a slotted server;
# an explicit kv_layout= wins.
ENV_KV_LAYOUT = "KATA_TPU_KV_LAYOUT"

# ----- telemetry (obs/, guest/serving.py) ------------------------------------

# Serving heartbeat cadence in rounds: one ``serving_heartbeat`` event every
# K rounds, which the device ledger and the watchdog ride on. Default 32; 0
# disables heartbeat, ledger, watchdog and the loop-phase clock. A malformed
# or negative value degrades to the default with a ``heartbeat_invalid``
# event; an explicit heartbeat_rounds= < 0 raises.
ENV_HEARTBEAT_ROUNDS = "KATA_TPU_HEARTBEAT_ROUNDS"
DEFAULT_HEARTBEAT_ROUNDS = 32

# The daemon's per-allocation trace id: a server adopts it for every span
# and event it emits (else it mints one).
ENV_TRACE_CTX = "KATA_TPU_TRACE_CTX"

# Device ledger kill switch: "0" disarms it on heartbeat-armed servers.
ENV_DEVLEDGER = "KATA_TPU_DEVLEDGER"

# SLO-burn watchdog: "0" disarms it node-wide; the rest tune its rules
# (obs/watchdog.py), each degrading to its default when malformed.
ENV_WATCHDOG = "KATA_TPU_WATCHDOG"
ENV_WATCHDOG_BURN = "KATA_TPU_WATCHDOG_BURN"
ENV_WATCHDOG_WINDOW = "KATA_TPU_WATCHDOG_WINDOW"
ENV_WATCHDOG_SUSTAIN = "KATA_TPU_WATCHDOG_SUSTAIN"
ENV_WATCHDOG_CLEAR = "KATA_TPU_WATCHDOG_CLEAR"
ENV_WATCHDOG_PREEMPT_STORM = "KATA_TPU_WATCHDOG_PREEMPT_STORM"
ENV_WATCHDOG_RECOVERY_STORM = "KATA_TPU_WATCHDOG_RECOVERY_STORM"
ENV_WATCHDOG_PROFILE_DIR = "KATA_TPU_WATCHDOG_PROFILE_DIR"
ENV_WATCHDOG_PROFILE_STEPS = "KATA_TPU_WATCHDOG_PROFILE_STEPS"
ENV_WATCHDOG_GAP_RATIO = "KATA_TPU_WATCHDOG_GAP_RATIO"
ENV_WATCHDOG_GAP_MIN_MS = "KATA_TPU_WATCHDOG_GAP_MIN_MS"
ENV_WATCHDOG_HEADROOM_FLOOR = "KATA_TPU_WATCHDOG_HEADROOM_FLOOR"

# Strict mode: "1"/"true"/"yes"/"on" guards every overlapped round against
# host synchronization (compat/torchapi.py); strict= on the server wins.
ENV_STRICT = "KATA_TPU_STRICT"

# ----- crash tolerance (guest/resilience.py, guest/serving.py) ---------------

# Fault schedule of the server's default injector: a comma-separated
# ``<seam>:<round>[:<kind>[:<device>]]`` list; malformed entries are skipped
# with a ``fault_schedule_error`` event. Its RNG seed (malformed: 0).
ENV_FAULTS = "KATA_TPU_FAULTS"
ENV_FAULTS_SEED = "KATA_TPU_FAULTS_SEED"

# Watchdog deadline in seconds of every blocking device-to-host wait of the
# serving loop; unset or 0 waits inline. Malformed: off, with a
# ``fence_timeout_disabled`` event; an explicit fence_timeout_s= wins.
ENV_FENCE_TIMEOUT = "KATA_TPU_FENCE_TIMEOUT_S"

# A file whose appearance drains the server (resilience.wire_drain).
ENV_MAINTENANCE_FILE = "KATA_TPU_MAINTENANCE_FILE"

# Consecutive implicated failed rounds after which a request is failed on
# its own (default 3, at least 1); malformed: the default, with a
# ``quarantine_k_invalid`` event; an explicit quarantine_after= wins.
ENV_QUARANTINE_K = "KATA_TPU_QUARANTINE_K"

# First recovery backoff in seconds, doubled a consecutive failure up to
# 5 s (default 0.05); malformed: the default, with a
# ``recovery_backoff_invalid`` event; an explicit recovery_backoff_s= wins.
ENV_RECOVERY_BACKOFF_S = "KATA_TPU_RECOVERY_BACKOFF_S"

# Rounds between host KV checkpoints of the live lanes (0, the default:
# none, recovery replays from the prompt); malformed: 0, with a
# ``checkpoint_disabled`` event; an explicit checkpoint_rounds= wins.
ENV_CHECKPOINT_ROUNDS = "KATA_TPU_CHECKPOINT_ROUNDS"

# "0" turns the recovery supervisor off: a fault unwinds run().
ENV_RECOVERY = "KATA_TPU_RECOVERY"

# Degraded mode: "0" turns the tensor-parallel shrink after a permanent
# fault off (the load then fails loudly); KATA_TPU_TP_MIN floors the
# shrink ladder (default 1; malformed: 1, with a ``tp_min_invalid`` event).
ENV_DEGRADED = "KATA_TPU_DEGRADED"
ENV_TP_MIN = "KATA_TPU_TP_MIN"

# W8A8: "1" at process start turns int8-weight matmuls into int8 x int8
# dots with per-row activation scales (ops/quant.py; read once at import,
# harnesses switch it with ops.quant.set_w8a8). MoE experts stay
# weight-only int8.
ENV_W8A8 = "KATA_TPU_W8A8"
