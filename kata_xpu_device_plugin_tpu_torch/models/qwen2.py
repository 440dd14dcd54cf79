"""Qwen2 configs (counterpart of ``kata_xpu_device_plugin_tpu/models/qwen2.py``):
the Llama layout (GQA, SwiGLU, untied unembedding, no embedding scaling)
with additive biases on the q/k/v projections. Qwen2-7B (public Qwen2
report): 28 layers, d_model 3584, 28 query heads over 4 KV heads (a group
of 7), head_dim 128, d_ff 18944, rope theta 1e6, vocabulary 152064."""
from __future__ import annotations

from dataclasses import replace

from .transformer import DecoderConfig


def qwen2_7b(**overrides) -> DecoderConfig:
    cfg = DecoderConfig(
        vocab_size=152064, d_model=3584, n_layers=28, n_heads=28,
        n_kv_heads=4, head_dim=128, d_ff=18944, rope_theta=1e6,
        norm_eps=1e-6, activation="swiglu", scale_embeddings=False,
        tie_embeddings=False, qkv_bias=True,
    )
    return replace(cfg, **overrides)


def qwen2_test_config(**overrides) -> DecoderConfig:
    """Qwen2 architecture at test scale."""
    cfg = DecoderConfig(
        vocab_size=512, d_model=128, n_layers=2, n_heads=8, n_kv_heads=4,
        head_dim=16, d_ff=256, rope_theta=1e6, norm_eps=1e-6,
        activation="swiglu", scale_embeddings=False, tie_embeddings=False,
        qkv_bias=True,
    )
    return replace(cfg, **overrides)
