"""Symmetric int8 quantization: weight-only int8 matmuls and the int8 KV
cache (counterpart of ``kata_xpu_device_plugin_tpu/ops/quant.py``).

    scale[out] = max(|w[:, out]|) / 127          (fp32; an amax of 0 gives 1)
    q[in, out] = clip(round(w[in, out] / scale[out]), -127, 127)   (int8)

``torch.round`` rounds half to even, as ``jnp.round`` does, so int8
payloads are bit-equal to the JAX package's on the same fp32 input.

W8A8 (opt-in, ``KATA_TPU_W8A8=1`` at import or :func:`set_w8a8`): an int8
weight's matmul quantizes the activation per row as well and runs an
int8 x int8 -> int32 product, both scales applied after it. The mode is
read when the matmul runs, so a CUDA graph keeps the mode it was captured
under (a JAX executable keeps the one it was traced under): set it before
building a server.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch

from ..constants import ENV_W8A8

# Layer-dict keys whose weights quantize: the dense matrices and the MoE
# expert stacks (per-expert, per-output-channel scales ``[L, E, 1, out]``;
# the router stays fp, so routing is untouched). Norm scales never are.
QUANTIZABLE = ("wqkv", "wq", "wk", "wv", "wo", "w_gateup", "w_gate", "w_up",
               "w_down", "moe_w_gate", "moe_w_in", "moe_w_out")

# Read once at import, as the JAX package does: harnesses switch it with
# set_w8a8(), not by changing the environment.
_W8A8 = os.environ.get(ENV_W8A8, "") == "1"

# torch._int_mm (cuBLASLt int8) takes more than 16 rows and K, N in
# multiples of 8: a decode's few rows are padded up to this many.
INT_MM_MIN_ROWS = 32


def set_w8a8(on: bool) -> None:
    """Switch W8A8 for matmuls run from now on (a captured graph keeps the
    mode it was captured under)."""
    global _W8A8
    _W8A8 = bool(on)


def w8a8_enabled() -> bool:
    """Whether int8 weights take int8 x int8 dots (module docstring)."""
    return _W8A8


class QTensor(NamedTuple):
    """``deq = q * scale`` with ``scale`` broadcastable against ``q``."""

    q: torch.Tensor  # int8
    scale: torch.Tensor  # fp32, size 1 on the reduced axis


def quantize(w: torch.Tensor, dim: int = -2) -> QTensor:
    """Symmetric int8 quantization, reducing |w| over ``dim`` (default: the
    input axis, one scale per output channel)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return QTensor(q.to(torch.int8), scale)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (qt.q.float() * qt.scale).to(dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and a.dtype != torch.float32:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(a.shape[:-1] + (b.shape[-1],))
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """Forward: :func:`_mm_f32`. Backward: two matmuls in the operands'
    dtype, whose results are the cotangents in that dtype — JAX's
    ``dot_general`` transpose rule likewise converts each cotangent to its
    operand's dtype. The fp32 cotangent goes down to that dtype first, so
    on the card both products stay bf16 tensor-core GEMMs (fp32 ones at
    vocabulary width would cost several times the forward)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = g.to(a.dtype) @ b.to(a.dtype).t()
        if ctx.needs_input_grad[1]:
            a2 = a.reshape(-1, a.shape[-1])
            gb = (a2.t() @ g.reshape(-1, g.shape[-1]).to(a.dtype)).to(b.dtype)
        return ga, gb


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a [E, m, k] @ b [E, k, n]`` with an fp32 result from
    operands of a's dtype (one cuBLAS call on CUDA, fp32 operands on the
    CPU). Not differentiable: the int8 experts it serves are frozen."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a [..., k] @ b [k, n]`` of int8 operands, int32 out. On CUDA
    ``torch._int_mm``, its rows padded with zeros to
    :data:`INT_MM_MIN_ROWS` (a decode has as few as one row a lane) and
    sliced back; on the CPU an int32 matmul."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda:
        m = a2.shape[0]
        if m < INT_MM_MIN_ROWS or m % 8:
            rows = max(INT_MM_MIN_ROWS, -(-m // 8) * 8)
            a2 = torch.cat([a2, a2.new_zeros((rows - m, a2.shape[1]))])
        out = torch._int_mm(a2, b)[:m]
    else:
        out = a2.to(torch.int32) @ b.to(torch.int32)
    return out.reshape(a.shape[:-1] + (b.shape[-1],))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result from operands of a's dtype: on CUDA one
    cuBLAS call that writes fp32 (``aten::mm.dtype``); on the CPU the
    operands go up to fp32 first (exact for bf16). ``a`` is ``[..., k]``
    and ``b`` is ``[k, n]``. Differentiable through :class:`_MatmulF32`,
    so the gradient does not depend on whether PyTorch has a formula for
    ``mm.dtype``."""
    return _MatmulF32.apply(a, b)


def weight_matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """The decoder's ``activation @ weight``: a cast-to-activation-dtype
    matmul for tensors; for a :class:`QTensor` the int8 form
    ``(x @ q) * scale`` in fp32, cast back to x's dtype (the cast makes an
    activation-dtype copy of the whole weight each call), or under W8A8
    the int8 x int8 dot with ``y * x_scale * w_scale`` after it; for a
    :class:`.lora.LoRAWeight` the frozen base plus its low-rank delta."""
    if isinstance(w, QTensor):
        if _W8A8:
            xq = quantize(x, dim=-1)  # one scale a row
            y = int8_matmul(xq.q, w.q)
            return (y.float() * xq.scale * w.scale[..., 0, :]).to(x.dtype)
        y = matmul_f32(x, w.q.to(x.dtype))
        return (y * w.scale[..., 0, :]).to(x.dtype)
    if isinstance(w, tuple):  # LoRAWeight (lora imports this module)
        from .lora import LoRAWeight, lora_matmul

        if isinstance(w, LoRAWeight):
            return lora_matmul(x, w)
        raise TypeError(f"unknown weight wrapper {type(w).__name__}")
    return x @ w.to(x.dtype)


def quantize_decoder_params(params: dict) -> dict:
    """Quantize a decoder param dict's layer weight matrices to int8
    (:data:`QUANTIZABLE` keys; everything else passes through). Quantize
    after ``fuse_decoder_params``: fusing concatenates raw matrices."""
    layers = params["layers"]
    if any(isinstance(v, QTensor) for v in layers.values()):
        return params
    if any(isinstance(v, tuple) for v in layers.values()):
        # Quantizing around live adapters would leave the wrapped weights
        # unquantized. Both right orders exist:
        raise ValueError(
            "params contain LoRA adapters: for QLoRA quantize FIRST then "
            "apply_lora; for int8 serving of a tuned model merge_lora "
            "first, then quantize")
    out = dict(params)
    out["layers"] = {
        k: (quantize(v) if k in QUANTIZABLE else v) for k, v in layers.items()
    }
    return out


def quantize_kv(x: torch.Tensor) -> QTensor:
    """Fresh k/v vectors for the int8 KV cache: one scale per (batch,
    position, kv-head) vector. ``[..., KV, D]`` → q ``[..., KV, D]`` int8,
    scale ``[..., KV, 1]``."""
    return quantize(x, dim=-1)


def dequantize_kv(cache, dtype) -> torch.Tensor:
    """Read side of the int8 KV cache: a no-op for plain tensors; the scale
    multiply runs in fp32 before the cast, as the kernels do it."""
    if isinstance(cache, QTensor):
        return (cache.q.float() * cache.scale).to(dtype)
    return cache
