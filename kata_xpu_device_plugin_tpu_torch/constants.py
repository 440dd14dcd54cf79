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
