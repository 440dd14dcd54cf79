"""Mistral configs (counterpart of ``kata_xpu_device_plugin_tpu/models/mistral.py``):
GQA, SwiGLU and a 4096-token sliding window on every layer (public
Mistral-7B-v0.1 release)."""
from __future__ import annotations

from dataclasses import replace

from .transformer import DecoderConfig, tiny_test_config


def mistral_7b(**overrides) -> DecoderConfig:
    cfg = DecoderConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, rope_theta=10000.0,
        norm_eps=1e-5, activation="swiglu", scale_embeddings=False,
        tie_embeddings=False, sliding_window=4096,
    )
    return replace(cfg, **overrides)


def mistral_test_config(**overrides) -> DecoderConfig:
    """Mistral's flags at test widths, with a window of 8 so that the band
    mask engages at test lengths."""
    base = tiny_test_config(activation="swiglu", scale_embeddings=False,
                            tie_embeddings=False, sliding_window=8)
    return replace(base, **overrides)
