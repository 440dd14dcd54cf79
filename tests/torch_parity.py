"""Shared helper for the PyTorch-port parity tests: one place makes the JAX
parameters from a seed, turns them into numpy, and carries them into the
port through its weight bridge, so every ``test_torch_*`` file compares the
two packages on identical weights (fp32 on both sides, the CPU)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kata_xpu_device_plugin_tpu.models import gemma as jgemma
from kata_xpu_device_plugin_tpu.models import llama as jllama
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant


def gemma_tiny(**overrides):
    """Gemma-2B's flags (MQA, GeGLU, embedding scale, tied unembedding) at
    test widths."""
    kw = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=1, head_dim=16, d_ff=128, dtype=jnp.float32)
    kw.update(overrides)
    return jgemma.gemma_2b(**kw)


CONFIGS = {
    "tiny": lambda: jt.tiny_test_config(dtype=jnp.float32),
    "gemma_tiny": gemma_tiny,
    "llama3_test": lambda: jllama.llama3_train_test(dtype=jnp.float32),
}


def build_pair(jcfg, seed: int = 0, fused: bool = False,
               quantized: bool = False):
    """``(jax_params, torch_params, torch_cfg)`` for one JAX config: the
    JAX params initialised from ``seed`` (optionally fused, then int8
    quantized), and the port's copy on the CPU through the bridge."""
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    if fused:
        params = jt.fuse_decoder_params(params)
    if quantized:
        params = jquant.quantize_decoder_params(params)
    tcfg = bridge.config_from_fields(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")
    return params, tparams, tcfg


def pool_from_jax(arena):
    """A JAX KV cache or pool pytree (``(k, v)``, arrays or int8 QTensors)
    as the port's leaves on the CPU, copied through numpy, so that pool ops
    and paged forwards of the two packages can be compared row for row."""
    def leaf(c):
        if isinstance(c, jquant.QTensor):
            return tquant.QTensor(torch.from_numpy(np.array(c.q)),
                                  torch.from_numpy(np.array(c.scale)))
        return torch.from_numpy(np.array(c))

    return tuple(leaf(c) for c in arena)


def pool_to_numpy(arena) -> list:
    """The leaves of either package's cache pair as numpy arrays, in the
    order k payload, [k scale,] v payload[, v scale]."""
    out = []
    for c in arena:
        for t in (c if isinstance(c, tuple) else (c,)):
            out.append(t.numpy() if hasattr(t, "numpy") else np.asarray(t))
    return out
