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
