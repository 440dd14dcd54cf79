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
