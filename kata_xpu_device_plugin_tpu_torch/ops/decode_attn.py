"""Paged single-token decode attention: the CUDA kernel
``csrc/paged_decode.cu`` and its plain version (counterpart of the paged
kernel in ``kata_xpu_device_plugin_tpu/ops/decode_attn.py``).

Each lane's query attends its block-table view of a shared pool
``[1, NT, KV, D]`` (bf16, or an int8 :class:`.quant.QTensor` with fp32
scales ``[1, NT, KV, 1]`` dequantized inside the kernel). The slotted
arena reaches it through :func:`.attention.make_decode_attn_fn`'s
zero-copy re-view. The multi-query (SQ > 1) and shard-local forms wait
for the paged-pool and tensor-parallel slices.
"""
from __future__ import annotations

import ctypes

import torch

from .attention import reference_attention
from .quant import QTensor, dequantize_kv

KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_GROUPS = (1, 2, 4, 8)


def supports_paged_decode(d: int, block_size: int) -> bool:
    """Shape gate, as in the JAX package: head_dim a multiple of 128 or 64,
    the KV tile (one pool block) a positive multiple of 8."""
    return (d % 128 == 0 or d == 64) and block_size >= 8 and block_size % 8 == 0


def check_kernel_shapes(d: int, group: int, block_size: int) -> None:
    """The one gate of the CUDA kernel: raise unless it takes head_dim
    ``d``, ``group`` query heads per KV head and KV tile ``block_size``.
    The wrapper calls it before every launch; the serving decode builder
    calls it once, so a server the kernel cannot serve fails at
    construction."""
    if (not supports_paged_decode(d, block_size) or d not in KERNEL_HEAD_DIMS
            or group not in KERNEL_GROUPS):
        raise ValueError(
            f"paged decode kernel: head_dim {d} (need {KERNEL_HEAD_DIMS}), "
            f"group {group} (need {KERNEL_GROUPS}), KV tile {block_size} "
            "(need a positive multiple of 8)"
        )


def _grid_k(tables: torch.Tensor, block_size: int, paged_len: int) -> int:
    """Splits visible through a lane's view: ``min(NB, ceil(paged_len/bs))``."""
    return min(tables.shape[1], -(-paged_len // block_size))


def paged_decode_reference(q, k, v, tables, pos, *, block_size: int,
                           paged_len: int) -> torch.Tensor:
    """The plain version: gather each lane's view out of the pool, dequantize,
    attend with per-lane offsets ``pos``. The view spans the kernel's
    ``grid_k`` splits, so a dead lane whose stale ``pos`` lies past
    ``paged_len`` sees the same keys the kernel reads."""
    B = q.shape[0]
    bs = block_size
    n = _grid_k(tables, bs, paged_len)
    idx = (tables[:, :n].long() * bs)[:, :, None] + torch.arange(
        bs, device=tables.device)
    idx = idx.reshape(B, -1)

    def view(c):
        if isinstance(c, QTensor):
            return dequantize_kv(QTensor(c.q[0][idx], c.scale[0][idx]), q.dtype)
        return c[0][idx]

    return reference_attention(q, view(k), view(v), causal=True,
                               q_offset=pos.to(q.device))


def _lib():
    from . import _build

    fn = _build.load("paged_decode").paged_decode_bf16
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                       ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q, k, v, tables, pos, *, block_size: int,
                           paged_len: int) -> torch.Tensor:
    """q ``[B, 1, H, D]``; k/v pool slices ``[1, NT, KV, D]`` (tensor or
    int8 QTensor); tables ``[B, NB]`` and pos ``[B]`` int32 (pos = the
    lane's query position). On CUDA it launches the kernel or raises; on
    the CPU it runs :func:`paged_decode_reference`."""
    quantized = isinstance(k, QTensor)
    kq = k.q if quantized else k
    B, Sq, H, D = q.shape
    NT, KV = kq.shape[1], kq.shape[2]
    bs = block_size
    if Sq != 1:
        raise NotImplementedError("multi-query decode spans are not ported yet")
    if H % KV or NT % bs:
        raise ValueError(f"bad decode shapes: H={H} KV={KV} NT={NT} bs={bs}")
    if not q.is_cuda:
        return paged_decode_reference(q, k, v, tables, pos, block_size=bs,
                                      paged_len=paged_len)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged decode kernel takes bf16 queries, got {q.dtype}")
    check_kernel_shapes(D, H // KV, bs)
    if quantized:
        vq = v.q
        operands = (k.q, vq, k.scale, v.scale)
        if kq.dtype != torch.int8 or vq.dtype != torch.int8:
            raise TypeError("int8 pools must hold int8 payloads")
        if k.scale.dtype != torch.float32 or v.scale.dtype != torch.float32:
            raise TypeError("int8 pools need fp32 scales")
    else:
        operands = (k, v)
        if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
            raise TypeError(f"paged decode kernel takes bf16 pools, got {k.dtype}")
    tables = tables.to(torch.int32)
    pos = pos.to(torch.int32)
    for t in (q, tables, pos) + operands:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged decode kernel operands must be contiguous "
                             "and on q's device")
    out = torch.empty_like(q)
    if quantized:
        kp, vp, ks, vs = (t.data_ptr() for t in operands)
    else:
        kp, vp = (t.data_ptr() for t in operands)
        ks = vs = None
    err = _lib()(
        q.data_ptr(), kp, vp, ks, vs, tables.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, H, KV, D, tables.shape[1], bs,
        _grid_k(tables, bs, paged_len), int(quantized), 1.0 / float(D) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
