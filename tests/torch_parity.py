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
from kata_xpu_device_plugin_tpu.models import mistral as jmistral
from kata_xpu_device_plugin_tpu.models import qwen2 as jqwen2
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant

# The parity tests' forwards are tiny and the suite runs several xdist
# workers at once: more than one torch thread a worker only contends with
# the other workers and with JAX's compiles. Every worker imports this
# module when it collects the port's tests.
torch.set_num_threads(1)


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


# The dense families beyond Gemma-1 and Llama-3, at their test widths.
FAMILIES = {
    "qwen2": lambda: jqwen2.qwen2_test_config(dtype=jnp.float32),
    "mistral": lambda: jmistral.mistral_test_config(dtype=jnp.float32),
    "gemma2": lambda: jgemma.gemma2_test_config(dtype=jnp.float32),
    "gemma3": lambda: jgemma.gemma3_test_config(dtype=jnp.float32),
}

# Leaves that init_params makes constant (biases 0, norm scales 1, which
# rms_norm reads as 1 + scale): a missing term would not show on them.
PERTURBED = ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm",
             "q_norm", "k_norm", "bq", "bk", "bv")


def perturb(params, seed: int, scale: float = 0.3):
    """The JAX params with every leaf of :data:`PERTURBED` and the final
    norm moved by ``scale`` x a standard normal drawn with numpy from
    ``seed``."""
    rng = np.random.default_rng(seed)

    def moved(a):
        return a + jnp.asarray(scale * rng.standard_normal(a.shape), a.dtype)

    layers = {k: moved(v) if k in PERTURBED else v
              for k, v in params["layers"].items()}
    return {**params, "layers": layers,
            "final_norm": moved(params["final_norm"])}


def build_pair(jcfg, seed: int = 0, fused: bool = False,
               quantized: bool = False, perturbed: bool = False):
    """``(jax_params, torch_params, torch_cfg)`` for one JAX config: the
    JAX params initialised from ``seed`` (optionally with the biases and
    norms moved off their constants by :func:`perturb`, fused, then int8
    quantized), and the port's copy on the CPU through the bridge."""
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    if perturbed:
        params = perturb(params, seed)
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


def numpy_pair(jcfg, seed: int = 0):
    """``(jax_params, torch_params, torch_cfg)`` like :func:`build_pair`,
    with every leaf drawn by numpy from ``seed`` in the shapes JAX's
    ``init_params`` gives (matrices normal / sqrt(fan_in), vectors such as
    norms and biases 0.3 x normal, so no term sits at a constant): the
    same arrays on both sides without compiling JAX's initializer, whose
    compile is most of a small test's time."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jcfg),
                            jax.random.PRNGKey(0))

    def leaf(sd):
        x = rng.standard_normal(sd.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(sd.shape[-2]) if len(sd.shape) >= 2 else 0.3
        if sd.shape and sd.shape[-1] == jcfg.d_model and len(sd.shape) == 2 \
                and sd.shape[0] == jcfg.vocab_size:
            scale = 1.0 / np.sqrt(jcfg.d_model)  # the embedding [vocab, d]
        return (x * scale).astype(np.dtype(sd.dtype))

    tree = jax.tree.map(leaf, shapes)
    tcfg = bridge.config_from_fields(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_numpy(tree, tcfg, "cpu")
    return jax.tree.map(jnp.asarray, tree), tparams, tcfg
