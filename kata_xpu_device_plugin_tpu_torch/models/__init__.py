"""Decoder models of the port: the transformer core, family configs and the
weight bridge from the JAX package's parameters."""
from .gemma import (
    gemma2_2b,
    gemma2_9b,
    gemma2_test_config,
    gemma3_4b,
    gemma3_test_config,
    gemma_2b,
    gemma_7b,
)
from .llama import llama3_8b, llama3_train_test, llama31_8b
from .mistral import mistral_7b, mistral_test_config
from .qwen2 import qwen2_7b, qwen2_test_config
from .transformer import (
    DecoderConfig,
    forward,
    fuse_decoder_params,
    generate,
    init_params,
    prefill,
    prefill_batch,
    sample_token,
    tiny_test_config,
)

__all__ = [
    "DecoderConfig", "forward", "fuse_decoder_params", "gemma2_2b",
    "gemma2_9b", "gemma2_test_config", "gemma3_4b", "gemma3_test_config",
    "gemma_2b", "gemma_7b", "generate", "init_params", "llama3_8b",
    "llama3_train_test", "llama31_8b", "mistral_7b", "mistral_test_config",
    "prefill", "prefill_batch", "qwen2_7b", "qwen2_test_config",
    "sample_token", "tiny_test_config",
]
