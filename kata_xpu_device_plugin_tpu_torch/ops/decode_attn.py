"""Decode attention: the CUDA kernels ``csrc/paged_decode.cu`` and
``csrc/dense_decode.cu`` with their plain versions (counterparts of the two
kernels in ``kata_xpu_device_plugin_tpu/ops/decode_attn.py``).

**Paged** (:func:`paged_decode_attention`): each lane's queries attend its
block-table view of a shared pool ``[1, NT, KV, D]`` (bf16, or an int8
:class:`.quant.QTensor` with fp32 scales ``[1, NT, KV, 1]`` dequantized
inside the kernel). A paged server hands it the pool and the lanes' real
tables; the slotted arena reaches it through
:func:`.attention.make_decode_attn_fn`'s zero-copy re-view. ``SQ > 1``
carries a right-aligned span per lane with per-lane query lengths. The
shard-local form with raw softmax statistics is not ported yet: it comes
with tensor-parallel serving.

**Dense** (:func:`decode_attention`): one token per row into a dense bf16
cache ``[B, S, KV, D]`` with one position shared by the batch, the
lock-step decode of ``generate`` under ``KATA_TPU_DECODE_KERNEL=1``.
"""
from __future__ import annotations

import ctypes

import torch

from .attention import reference_attention
from .quant import QTensor, dequantize_kv

KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_GROUPS = (1, 2, 4, 8)
# The query row is the grid's z dimension.
KERNEL_MAX_SQ = 65535
DENSE_BLOCK_K = 128


def supports_paged_decode(d: int, block_size: int) -> bool:
    """Shape gate, as in the JAX package: head_dim a multiple of 128 or 64,
    the KV tile (one pool block) a positive multiple of 8."""
    return (d % 128 == 0 or d == 64) and block_size >= 8 and block_size % 8 == 0


def supports_decode(sq: int, sk: int, d: int) -> bool:
    """Shape gate of the dense kernel, as in the JAX package: one query
    token, head_dim a multiple of 128 or 64, the cache length a positive
    multiple of the 128-key block."""
    return (sq == 1 and (d % 128 == 0 or d == 64)
            and sk % DENSE_BLOCK_K == 0 and sk >= DENSE_BLOCK_K)


def check_kernel_shapes(d: int, group: int, block_size: int) -> None:
    """The one gate of the paged CUDA kernel: raise unless it takes
    head_dim ``d``, ``group`` query heads per KV head and KV tile
    ``block_size``. The wrapper calls it before every launch; the serving
    decode builder calls it once, so a server the kernel cannot serve fails
    at construction."""
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


def paged_decode_reference(q, k, v, tables, pos, q_lens=None, *,
                           block_size: int, paged_len: int) -> torch.Tensor:
    """The plain version: gather each lane's view out of the pool, dequantize,
    attend with query row ``j`` at ``pos[b] - (SQ-1) + j``. The view spans
    the kernel's ``grid_k`` splits, so a dead lane whose stale ``pos`` lies
    past ``paged_len`` sees the same keys the kernel reads. Padding rows
    (``j < SQ - q_lens[b]``) have every key masked, so their probabilities
    are uniform: they take the mean of V over the whole view (the kernel's
    mean runs over the visited splits only; nothing reads either)."""
    B, SQ = q.shape[:2]
    bs = block_size
    n = _grid_k(tables, bs, paged_len)
    idx = (tables[:, :n].long() * bs)[:, :, None] + torch.arange(
        bs, device=tables.device)
    idx = idx.reshape(B, -1)

    def view(c):
        if isinstance(c, QTensor):
            return dequantize_kv(QTensor(c.q[0][idx], c.scale[0][idx]), q.dtype)
        return c[0][idx]

    vv = view(v)
    out = reference_attention(q, view(k), vv, causal=True,
                              q_offset=pos.to(q.device) - (SQ - 1))
    if q_lens is not None:
        pad = (torch.arange(SQ, device=q.device)[None, :]
               < SQ - q_lens.to(q.device)[:, None])  # [B, SQ]
        G = q.shape[2] // vv.shape[2]
        mean_v = vv.float().mean(dim=1).repeat_interleave(G, dim=1)  # [B, H, D]
        out = torch.where(pad[:, :, None, None], mean_v[:, None].to(out.dtype),
                          out)
    return out


def _lib():
    from . import _build

    fn = _build.load("paged_decode").paged_decode_bf16
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                       ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q, k, v, tables, pos, q_lens=None, *,
                           block_size: int, paged_len: int) -> torch.Tensor:
    """q ``[B, SQ, H, D]``; k/v pool slices ``[1, NT, KV, D]`` (tensor or
    int8 QTensor); tables ``[B, NB]``, pos ``[B]`` and q_lens ``[B]`` int32.
    ``pos[b]`` is the position of lane b's LAST query row; row ``j`` sits at
    ``pos[b] - (SQ-1) + j``; the leading ``SQ - q_lens[b]`` rows are padding
    and come back finite and unread (``q_lens=None``: every row is real).
    ``tables`` must have SCRATCH entries remapped to ZERO already. On CUDA
    it launches the kernel or raises; on the CPU it runs
    :func:`paged_decode_reference`."""
    quantized = isinstance(k, QTensor)
    kq = k.q if quantized else k
    B, Sq, H, D = q.shape
    NT, KV = kq.shape[1], kq.shape[2]
    bs = block_size
    if H % KV or NT % bs:
        raise ValueError(f"bad decode shapes: H={H} KV={KV} NT={NT} bs={bs}")
    if not q.is_cuda:
        return paged_decode_reference(q, k, v, tables, pos, q_lens,
                                      block_size=bs, paged_len=paged_len)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged decode kernel takes bf16 queries, got {q.dtype}")
    check_kernel_shapes(D, H // KV, bs)
    if not 1 <= Sq <= KERNEL_MAX_SQ:
        raise ValueError(f"paged decode kernel takes 1 to {KERNEL_MAX_SQ} query "
                         f"rows per lane, got {Sq}")
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
    scalars = (tables, pos)
    if q_lens is not None:
        q_lens = q_lens.to(torch.int32)
        scalars += (q_lens,)
    if pos.shape != (B,) or tables.shape[0] != B or (
            q_lens is not None and q_lens.shape != (B,)):
        raise ValueError("paged decode kernel: tables [B, NB], pos [B] and "
                         "q_lens [B] must match q's batch")
    for t in (q,) + scalars + operands:
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
        None if q_lens is None else q_lens.data_ptr(), out.data_ptr(), B, Sq,
        H, KV, D, tables.shape[1], bs, _grid_k(tables, bs, paged_len),
        int(quantized), 1.0 / float(D) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ----- the lock-step dense kernel ------------------------------------------


def decode_attention_reference(q, k, v, pos) -> torch.Tensor:
    """The plain version of :func:`decode_attention`: causal attention of
    the one query token at the shared position ``pos`` over the cache."""
    pos = torch.as_tensor(pos, device=q.device).reshape(())
    return reference_attention(q, k, v, causal=True, q_offset=pos)


def _dense_lib():
    from . import _build

    fn = _build.load("dense_decode").dense_decode_bf16
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k, v, pos) -> torch.Tensor:
    """q ``[B, 1, H, D]``; k/v the dense cache ``[B, S, KV, D]`` read in
    place; ``pos`` the one position shared by the batch, a 0-dim or ``[1]``
    integer tensor (the kernel reads it on the device: no host sync). On
    CUDA it launches the kernel or raises (bf16 only, ``supports_decode``
    shapes); on the CPU it runs :func:`decode_attention_reference`."""
    B, Sq, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if H % KV or k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"bad decode shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.is_cuda:
        return decode_attention_reference(q, k, v, pos)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("dense decode kernel takes bf16 queries and a bf16 "
                        f"cache, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (not supports_decode(Sq, S, D) or D not in KERNEL_HEAD_DIMS
            or H // KV not in KERNEL_GROUPS):
        raise ValueError(
            f"dense decode kernel: one query token (got {Sq}), cache length a "
            f"multiple of {DENSE_BLOCK_K} (got {S}), head_dim {D} (need "
            f"{KERNEL_HEAD_DIMS}), group {H // KV} (need {KERNEL_GROUPS})")
    if not torch.is_tensor(pos) or pos.numel() != 1 or not pos.is_cuda:
        raise ValueError("dense decode kernel reads its position on the "
                         "device: pass a 0-dim or [1] CUDA tensor")
    pos = pos.to(torch.int32).reshape(1)
    for t in (q, k, v, pos):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("dense decode kernel operands must be contiguous "
                             "and on q's device")
    out = torch.empty_like(q)
    err = _dense_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, S, H, KV, D, 1.0 / float(D) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"dense_decode kernel launch failed: cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
