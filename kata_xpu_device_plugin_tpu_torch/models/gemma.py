"""Gemma configs (counterpart of ``kata_xpu_device_plugin_tpu/models/gemma.py``):
MQA for 2B, GeGLU, RMSNorm with (1 + scale), RoPE, embeddings scaled by
sqrt(d_model), tied unembedding, vocabulary 256128 (public Gemma report).
Gemma-2 adds alternating local/global attention, post-sublayer norms and
soft caps on the attention and final logits; Gemma-3 a 5:1 local/global
pattern, per-head QK-norm and a rope base and linear factor per layer
type, without the caps (public Gemma-2 and Gemma-3 reports)."""
from __future__ import annotations

from dataclasses import replace

from .transformer import DecoderConfig, tiny_test_config


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


def gemma_2b_bench(**overrides) -> DecoderConfig:
    """The 2B architecture with the vocabulary cut to 32128 for one-card
    benchmarks: the 256k embedding costs memory at no benefit to a
    throughput benchmark of random weights. Layer compute is gemma_2b's."""
    return gemma_2b(vocab_size=32128, **overrides)


def gemma2_2b(**overrides) -> DecoderConfig:
    """Gemma-2 2B: a 4096-token window on even layers, global odd layers,
    pre and post norms on each sublayer, attention logits capped at 50 and
    final logits at 30, GQA 8/4."""
    cfg = DecoderConfig(
        vocab_size=256128, d_model=2304, n_layers=26, n_heads=8,
        n_kv_heads=4, head_dim=256, d_ff=9216, rope_theta=10000.0,
        activation="geglu", scale_embeddings=True, tie_embeddings=True,
        logits_softcap=30.0, attn_logits_softcap=50.0,
        attn_windows=(4096, 0), post_norms=True,
    )
    return replace(cfg, **overrides)


def gemma2_9b(**overrides) -> DecoderConfig:
    """Gemma-2 9B: the 2B block structure at d_model 3584, 42 layers, GQA
    16/8, d_ff 14336."""
    cfg = DecoderConfig(
        vocab_size=256128, d_model=3584, n_layers=42, n_heads=16,
        n_kv_heads=8, head_dim=256, d_ff=14336, rope_theta=10000.0,
        activation="geglu", scale_embeddings=True, tie_embeddings=True,
        logits_softcap=30.0, attn_logits_softcap=50.0,
        attn_windows=(4096, 0), post_norms=True,
    )
    return replace(cfg, **overrides)


def gemma2_test_config(**overrides) -> DecoderConfig:
    """Gemma-2's flags at test widths: an alternating window of 6, post
    norms, both caps, 4 layers (two cycles)."""
    base = tiny_test_config(n_layers=4, logits_softcap=30.0,
                            attn_logits_softcap=50.0, attn_windows=(6, 0),
                            post_norms=True)
    return replace(base, **overrides)


def gemma3_4b(**overrides) -> DecoderConfig:
    """Gemma-3 4B text: a 1024-token window on five layers of every six
    (the 34-layer tail cuts the last period, as the released checkpoint's
    layer types do), QK-norm, rope base 10k on local and 1M with linear
    factor 8 on global layers, pre and post norms, no logit caps."""
    n_layers = 34
    windows = tuple(1024 if (i + 1) % 6 else 0 for i in range(n_layers))
    cfg = DecoderConfig(
        vocab_size=262208, d_model=2560, n_layers=n_layers, n_heads=8,
        n_kv_heads=4, head_dim=256, d_ff=10240, rope_theta=1_000_000.0,
        activation="geglu", scale_embeddings=True, tie_embeddings=True,
        post_norms=True, qk_norm=True, attn_windows=windows,
        rope_theta_cycle=tuple(10000.0 if w else 1_000_000.0 for w in windows),
        rope_linear_cycle=tuple(1.0 if w else 8.0 for w in windows),
    )
    return replace(cfg, **overrides)


def gemma3_test_config(**overrides) -> DecoderConfig:
    """Gemma-3's flags at test widths: QK-norm, a 2:1 local/global cycle
    with two rope bases and a linear factor on the global layer."""
    cfg = DecoderConfig(
        vocab_size=512, d_model=128, n_layers=6, n_heads=8, n_kv_heads=4,
        head_dim=16, d_ff=256, rope_theta=100_000.0, activation="geglu",
        scale_embeddings=True, tie_embeddings=True, post_norms=True,
        qk_norm=True, attn_windows=(8, 8, 0),
        rope_theta_cycle=(10000.0, 10000.0, 100_000.0),
        rope_linear_cycle=(1.0, 1.0, 8.0),
    )
    return replace(cfg, **overrides)
