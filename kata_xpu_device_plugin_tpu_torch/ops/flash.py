"""Flash attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
gate (counterpart of ``kata_xpu_device_plugin_tpu/ops/flash.py``).

Eligibility (:func:`pick_block`, :func:`supports`) is decided exactly as
in the JAX package; the kernel picks its own tiles (64 query rows by 32
keys), since the TPU's 1024-row blocks do not fit a Hopper SM. The plain
version is :func:`.attention.reference_attention`, taken only for CPU
tensors. The logsumexp output and nonzero offsets (training, ring
attention) are not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .attention import reference_attention

DEFAULT_BLOCK = 1024
KERNEL_HEAD_DIMS = (64, 128, 256)


def pick_block(seq_len: int, requested: int) -> Optional[int]:
    """Largest block <= requested that divides ``seq_len``, is a multiple
    of 32 and at least 128; None when none exists."""
    start = min(requested, seq_len)
    start -= start % 32
    for b in range(start, 127, -32):
        if seq_len % b == 0:
            return b
    return None


def supports(sq: int, sk: int, d: int) -> bool:
    """Whether the flash path takes these self-attention shapes."""
    return (
        (d % 128 == 0 or d == 64)
        and pick_block(sq, DEFAULT_BLOCK) is not None
        and pick_block(sk, DEFAULT_BLOCK) is not None
    )


def _lib():
    from . import _build

    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd_bf16
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, L, L,
                       L, I, I, ctypes.c_float, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows with 16-byte loads: the last dim contiguous,
    every stride a multiple of 8 elements, the base 16-byte aligned.
    Anything else (never the transformer's own views) is copied."""
    ok = (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """Self-attention, q ``[B, Sq, H, D]``; k/v ``[B, Sk, KV, D]``. On a CUDA
    tensor it launches the kernel (bf16, D in 64/128/256) or raises; on a
    CPU tensor it runs the plain version."""
    if window > 0 and not causal:
        raise ValueError("sliding window implies causal attention")
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {KV}")
    if pick_block(Sq, DEFAULT_BLOCK) is None or pick_block(Sk, DEFAULT_BLOCK) is None:
        raise ValueError(
            f"no valid flash block for Sq={Sq}, Sk={Sk} (need a divisor >= 128, "
            "multiple of 32); use reference_attention"
        )
    if not q.is_cuda:
        return reference_attention(q, k, v, causal=causal, window=window,
                                   logits_softcap=softcap)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash kernel takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim {D} not in {KERNEL_HEAD_DIMS}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window), float(softcap), 1.0 / float(D) ** 0.5,
        stream,
    )
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_forward.launches += 1
    return out


flash_forward.launches = 0
