"""Gemma configs (counterpart of ``kata_xpu_device_plugin_tpu/models/gemma.py``):
MQA for 2B, GeGLU, RMSNorm with (1 + scale), RoPE, embeddings scaled by
sqrt(d_model), tied unembedding, vocabulary 256128 (public Gemma report)."""
from __future__ import annotations

from dataclasses import replace

from .transformer import DecoderConfig


def gemma_2b(**overrides) -> DecoderConfig:
    cfg = DecoderConfig(
        vocab_size=256128, d_model=2048, n_layers=18, n_heads=8,
        n_kv_heads=1, head_dim=256, d_ff=16384, rope_theta=10000.0,
        activation="geglu", scale_embeddings=True, tie_embeddings=True,
    )
    return replace(cfg, **overrides)


def gemma_7b(**overrides) -> DecoderConfig:
    cfg = DecoderConfig(
        vocab_size=256128, d_model=3072, n_layers=28, n_heads=16,
        n_kv_heads=16, head_dim=256, d_ff=24576, rope_theta=10000.0,
        activation="geglu", scale_embeddings=True, tie_embeddings=True,
    )
    return replace(cfg, **overrides)
