"""Decoder models of the port: the transformer core, family configs and the
weight bridge from the JAX package's parameters."""
from .gemma import gemma_2b, gemma_7b
from .llama import llama3_8b, llama3_train_test, llama31_8b
from .transformer import (
    DecoderConfig,
    forward,
    fuse_decoder_params,
    generate,
    init_params,
    prefill,
    prefill_batch,
    tiny_test_config,
)

__all__ = [
    "DecoderConfig", "forward", "fuse_decoder_params", "gemma_2b", "gemma_7b",
    "generate", "init_params", "llama3_8b", "llama3_train_test", "llama31_8b",
    "prefill", "prefill_batch", "tiny_test_config",
]
