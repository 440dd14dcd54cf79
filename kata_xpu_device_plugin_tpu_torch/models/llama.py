"""Llama-3 configs (counterpart of ``kata_xpu_device_plugin_tpu/models/llama.py``):
GQA with 8 KV heads, SwiGLU, RoPE theta 500000, vocabulary 128256, untied
unembedding, no embedding scaling (public Llama 3 report)."""
from __future__ import annotations

from dataclasses import replace

from .transformer import DecoderConfig


def llama3_8b(**overrides) -> DecoderConfig:
    cfg = DecoderConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, rope_theta=500000.0,
        norm_eps=1e-5, activation="swiglu", scale_embeddings=False,
        tie_embeddings=False,
    )
    return replace(cfg, **overrides)


def llama31_8b(**overrides) -> DecoderConfig:
    """Llama-3.1 8B: Llama-3 plus the per-band rope rescale (factor 8 over
    an 8192-token original context)."""
    return replace(llama3_8b(rope_llama3_scaling=(8.0, 1.0, 4.0, 8192.0)),
                   **overrides)


def llama3_train_bench(**overrides) -> DecoderConfig:
    """Llama-3 architecture at one-card train-bench scale (~256M params,
    power-of-two widths, head_dim 64): a step is GEMM-bound, so its MFU
    means something, and params, AdamW moments and rematerialized
    activations fit one card beside a decode model."""
    cfg = DecoderConfig(
        vocab_size=32768, d_model=1024, n_layers=12, n_heads=16,
        n_kv_heads=8, head_dim=64, d_ff=4096, rope_theta=500000.0,
        norm_eps=1e-5, activation="swiglu", scale_embeddings=False,
        tie_embeddings=False,
    )
    return replace(cfg, **overrides)


def llama3_train_test(**overrides) -> DecoderConfig:
    """Llama-3 architecture at test scale."""
    cfg = DecoderConfig(
        vocab_size=512, d_model=128, n_layers=2, n_heads=8, n_kv_heads=4,
        head_dim=16, d_ff=256, rope_theta=500000.0, norm_eps=1e-5,
        activation="swiglu", scale_embeddings=False, tie_embeddings=False,
    )
    return replace(cfg, **overrides)
