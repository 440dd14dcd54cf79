"""Attention: the plain PyTorch version, the dispatch onto the flash
kernels, and the serving decode backend (counterpart of
``kata_xpu_device_plugin_tpu/ops/attention.py``).

Shapes: q ``[B, Sq, H, D]``; k/v ``[B, Sk, KV, D]`` with H a multiple of KV
(GQA: Gemma-2B has KV=1, Llama-3-8B KV=8). ``q_offset`` is the absolute
position of q's first token when attending into a longer KV prefix.
"""
from __future__ import annotations

import math
import os

import torch

from ..constants import ENV_DECODE_KERNEL

NEG_INF = -1e30

BACKEND_PAGED = "cuda_paged"
BACKEND_REFERENCE = "reference"
DECODE_ATTN_BACKENDS = (BACKEND_PAGED, BACKEND_REFERENCE)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset=None,
    window: int = 0,
    logits_softcap: float = 0.0,
) -> torch.Tensor:
    """Plain GQA attention: q's H heads fold into ``[KV, H/KV]`` groups so
    K/V are never repeated. Products of the input dtype are summed in fp32
    (bf16 goes up to fp32 first, which is exact), the softmax is fp32, and
    the probabilities are cast to v's dtype before the PV product.

    ``q_offset`` is a scalar or a ``[B]`` tensor of per-row offsets (ragged
    decode). ``window > 0`` (causal only) keeps the keys in
    ``(p - window, p]``; ``logits_softcap > 0`` caps the logits to
    ``tanh(l / c) · c`` before the mask."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {KV}")
    if window and not causal:
        raise ValueError("sliding window implies causal attention")
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits * (1.0 / float(D) ** 0.5)
    if logits_softcap:
        logits = torch.tanh(logits / logits_softcap) * logits_softcap
    if causal:
        dev = q.device
        q_pos = torch.arange(Sq, device=dev)
        k_pos = torch.arange(Sk, device=dev)
        if torch.is_tensor(q_offset) and q_offset.ndim == 1:
            qp = q_pos[None, :] + q_offset.to(dev)[:, None]  # [B, Sq]
            mask = k_pos[None, None, :] <= qp[:, :, None]  # [B, Sq, Sk]
            if window > 0:
                mask &= k_pos[None, None, :] > qp[:, :, None] - window
            mask = mask[:, None, None]
        else:
            if q_offset is not None:
                q_pos = q_pos + q_offset
            mask = k_pos[None, :] <= q_pos[:, None]  # [Sq, Sk]
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_eligible(sq: int, sk: int, d: int, q_offset=None,
                   on_cuda: bool = False) -> bool:
    """Whether prefill self-attention takes the flash kernel: on a CUDA
    tensor, without a q_offset, at S >= 128 and a valid ``pick_block``."""
    from .flash import supports

    return on_cuda and q_offset is None and sq >= 128 and supports(sq, sk, d)


def decode_eligible(sq: int, sk: int, d: int, causal: bool, q_offset,
                    on_cuda: bool = False) -> bool:
    """Whether a decode-into-cache call takes the lock-step dense kernel:
    only under ``KATA_TPU_DECODE_KERNEL=1`` (it is off by default, as in
    the JAX package), on a CUDA tensor, causal, with ONE scalar offset
    shared by the batch, at a ``supports_decode`` shape."""
    from .decode_attn import supports_decode

    if os.environ.get(ENV_DECODE_KERNEL, "") != "1":
        return False
    scalar = q_offset is not None and (
        q_offset.ndim == 0 if torch.is_tensor(q_offset)
        else isinstance(q_offset, int))
    return causal and scalar and on_cuda and supports_decode(sq, sk, d)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset=None,
    window: int = 0,
    logits_softcap: float = 0.0,
) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors (PyTorch's autograd
    differentiates it); on CUDA the kernels or an error. On the card it
    takes only what the kernels take: self-attention (no ``q_offset``) at a
    ``pick_block`` length goes to the flash kernels, and a single token at
    a scalar offset into a dense cache goes to the lock-step dense decode
    kernel when :func:`decode_eligible` says so. A caller that wants the
    plain version there passes :func:`reference_attention` as its
    ``attn_fn``. With grad mode on, self-attention goes through
    :class:`.flash.FlashAttention`, whose backward is the two backward
    kernels."""
    if not q.is_cuda:
        return reference_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   window=window, logits_softcap=logits_softcap)
    if q_offset is not None:
        if (window == 0 and logits_softcap == 0.0 and decode_eligible(
                q.shape[1], k.shape[1], q.shape[3], causal, q_offset, True)):
            from .decode_attn import decode_attention

            if not torch.is_tensor(q_offset):
                q_offset = torch.tensor(q_offset, dtype=torch.int32,
                                        device=q.device)
            return decode_attention(q, k, v, q_offset)
        raise ValueError(
            "flash attention on CUDA takes prefill self-attention, or one "
            f"token at a scalar offset under {ENV_DECODE_KERNEL}=1 (the dense "
            "decode kernel); ragged decode into a cache goes through the "
            "paged decode kernel"
        )
    from .flash import FlashAttention, flash_forward

    if torch.is_grad_enabled():
        return FlashAttention.apply(q, k, v, causal, window, logits_softcap)
    return flash_forward(q, k, v, causal=causal, window=window,
                         softcap=logits_softcap)


def kernel_tolerance(out: torch.Tensor, ref: torch.Tensor,
                     weighted_abs: torch.Tensor) -> dict:
    """How far a bf16 attention kernel's output ``out`` may lie from the
    plain version's ``ref`` on the same inputs. ``weighted_abs`` is the
    plain version applied to ``|v|`` (``sum_i p_i |v_i|`` per element).

    Both sides take fp32 logits and round each probability to bf16 before
    the P·V product, at different scales (the kernel's running maximum,
    the plain version's normalized row), each within half a bf16 ulp,
    2^-8 relative; so their fp32 results differ by at most
    ``2^-7 · weighted_abs``, and each side's final rounding to bf16 adds
    half an ulp. Per element: ``|out - ref| <= 2^-7 · weighted_abs + 2 ulp
    (ref)``. Rounding errors of independent terms mostly cancel, so the
    mean error must also stay within ``2^-9 · mean(weighted_abs)``.
    Returns the errors, both bounds and ``ok``."""
    err = (out.float() - ref.float()).abs()
    mag = ref.float().abs().clamp_min(2.0 ** -30)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    bound = 2.0 ** -7 * weighted_abs.float() + 2 * ulp
    res = {
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "max_err_over_bound": float((err / bound).max()),
        "mean_bound": 2.0 ** -9 * float(weighted_abs.float().mean()),
    }
    res["ok"] = (math.isfinite(res["max_abs_err"])
                 and res["max_err_over_bound"] <= 1.0
                 and res["mean_abs_err"] <= res["mean_bound"])
    return res


def dense_decode_tile(arena_len: int) -> int:
    """KV tile for running the slotted arena through the paged decode
    kernel: ``[B, S, KV, D]`` re-views without a copy as the pool
    ``[1, B·S, KV, D]`` with ``table[b, j] = b·(S/t) + j``. The tile must
    divide the arena length; 0 means none fits."""
    for t in (128, 64, 32, 16, 8):
        if arena_len % t == 0:
            return t
    return 0


def make_decode_attn_fn(cfg, *, paged: bool = False, block_size: int = 0,
                        paged_len: int = 0, arena_len: int = 0, device=None):
    """Build the serving decode-attention callable
    ``fn(q, ck, cv, tables, pos, q_lens=None) -> [B, SQ, H, D]`` the
    transformer's ragged decode branches dispatch through (the JAX
    function's unsharded form).

    ``paged=True``: ``ck``/``cv`` are the layer's ``[1, NT, KV, D]`` pool
    slice (bf16 or int8 QTensor) and ``tables`` the lanes' view tables
    (SCRATCH already remapped to ZERO); the kernel's KV tile is the pool's
    ``block_size`` and the view ends at ``paged_len``. ``paged=False``: the
    slotted arena of ``arena_len`` positions re-views without a copy as a
    pool with synthetic identity tables, and ``tables`` is ignored.

    The returned function carries ``multi_query = True``: it takes spans of
    ``SQ > 1`` tokens with per-lane ``q_lens``. Raises on configs the
    kernel cannot model (sliding windows, the attention-logit softcap, an
    arena length no tile divides) and, for a CUDA ``device``, on shapes
    the kernel does not take."""
    from .decode_attn import check_kernel_shapes, paged_decode_attention

    if any(w > 0 for w in cfg.window_cycle):
        raise ValueError(
            "the paged decode kernel has no sliding-window mask — windowed "
            "configs need decode_attn='reference'"
        )
    if cfg.attn_logits_softcap:
        raise ValueError(
            "the paged decode kernel does not model the attention-logit "
            "softcap — capped configs need decode_attn='reference'"
        )
    if paged:
        bs, plen = int(block_size), int(paged_len)
        if bs < 1 or plen < 1:
            raise ValueError(f"a paged decode function needs block_size and "
                             f"paged_len, got {bs} and {plen}")
    else:
        bs, plen = dense_decode_tile(int(arena_len)), int(arena_len)
        if bs == 0:
            raise ValueError(f"no KV tile divides the arena length {plen}")
    if device is not None and torch.device(device).type == "cuda":
        check_kernel_shapes(cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, bs)
    nb_row = plen // bs
    table_cache: dict = {}

    def pool_form(q, ck, cv, tables, pos, q_lens=None):
        if not paged:
            B = q.shape[0]
            key = (B, q.device)
            if key not in table_cache:
                table_cache[key] = (
                    torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
                    * nb_row
                    + torch.arange(nb_row, dtype=torch.int32, device=q.device)
                )
            tables = table_cache[key]

            def reshape(a):
                return a.reshape((1, B * plen) + tuple(a.shape[2:]))

            if isinstance(ck, tuple):
                ck, cv = type(ck)(*map(reshape, ck)), type(cv)(*map(reshape, cv))
            else:
                ck, cv = reshape(ck), reshape(cv)
        return paged_decode_attention(
            q, ck, cv, tables, pos, q_lens, block_size=bs, paged_len=plen,
        )

    pool_form.multi_query = True
    return pool_form
