"""Mixtral configs (counterpart of
``kata_xpu_device_plugin_tpu/models/mixtral.py``): the mixture-of-experts
family. Public facts of the Mixtral report: 8 experts, top-2 routing with
renormalised gates, otherwise Llama's architecture (GQA with 8 KV heads,
SwiGLU experts, rope theta 1e6, vocabulary 32000, untied unembedding)."""
from __future__ import annotations

from dataclasses import replace

from .transformer import DecoderConfig, tiny_test_config


def mixtral_8x7b(**overrides) -> DecoderConfig:
    cfg = DecoderConfig(
        vocab_size=32000,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        rope_theta=1e6,
        norm_eps=1e-5,
        activation="swiglu",
        scale_embeddings=False,
        tie_embeddings=False,
        moe_num_experts=8,
        moe_top_k=2,
    )
    return replace(cfg, **overrides)


def mixtral_test_config(**overrides) -> DecoderConfig:
    """Mixtral's flags at test widths: 4 experts, top-2, capacity factor 4
    (ample: nothing drops, so outputs match the per-token reference)."""
    base = tiny_test_config(activation="swiglu", moe_num_experts=4,
                            moe_top_k=2, moe_capacity_factor=4.0)
    return replace(base, **overrides)
