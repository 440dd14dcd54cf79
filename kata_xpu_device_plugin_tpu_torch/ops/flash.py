"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward, with an
optional logsumexp) and ``csrc/flash_bwd.cu`` (dq; dk and dv per KV head),
their gates, their plain versions and the autograd function that joins
them (counterpart of ``kata_xpu_device_plugin_tpu/ops/flash.py``).

Eligibility (:func:`pick_block`, :func:`supports`) is decided exactly as
in the JAX package; the kernels pick their own tiles (64-row blocks, 32-row
inner tiles), since the TPU's 1024-row blocks do not fit a Hopper SM. The
plain versions are :func:`flash_reference` and
:func:`flash_backward_reference`, taken only for CPU tensors. Nonzero
offsets and the logsumexp cotangent of the ring API are not ported yet,
nor the backward at head_dim 256.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .attention import NEG_INF, reference_attention

DEFAULT_BLOCK = 1024
KERNEL_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128)


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


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _fn(source: str, name: str, argtypes: list):
    from . import _build

    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _fwd_lib():
    return _fn("flash_fwd", "flash_fwd_bf16",
               [_P] * 5 + [_I] * 6 + [_L] * 9 + [_I, _I, _F, _F, _P])


def _bwd_lib(name: str, n_out: int):
    return _fn("flash_bwd", name, [_P] * (6 + n_out) + [_I] * 6
               + [ctypes.POINTER(_L), _I, _I, _F, _F, _P])


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """The kernels read rows with 16-byte loads: the last dim contiguous,
    every stride a multiple of 8 elements, the base 16-byte aligned.
    Anything else (never the transformer's own views) is copied."""
    ok = (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def _check(q, k, v, causal, window):
    """Shapes both directions share; returns ``(B, Sq, H, D, Sk, KV)``."""
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
    return B, Sq, H, D, Sk, KV


def _check_cuda(*ts: torch.Tensor) -> None:
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"flash kernel takes bf16, got {[t.dtype for t in ts]}")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("flash kernel operands must be on one device")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# ----- plain versions ----------------------------------------------------------


def _logits(q, k, causal, window, softcap):
    """Self-attention logits as the kernels form them, fp32
    ``[B, KV, G, Sq, Sk]``: q·k times 1/sqrt(D), then the cap. Returns
    ``(logits, tanh or None, band mask or None)``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = s * (1.0 / float(D) ** 0.5)
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    mask = None
    if causal:
        qp = torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Sk, device=q.device)[None, :]
        mask = kp <= qp
        if window > 0:
            mask &= kp > qp - window
    return s, t, mask


def flash_reference(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Plain forward with the logsumexp: ``(out, lse)``, ``out`` as
    :func:`.attention.reference_attention` gives it and ``lse`` the fp32
    ``[B, H, Sq]`` logsumexp of the masked logits (``m + log l``, as the
    TPU kernel's ``_finalize`` writes it)."""
    B, Sq, H, _ = q.shape
    out = reference_attention(q, k, v, causal=causal, window=window,
                              logits_softcap=softcap)
    s, _, mask = _logits(q, k, causal, window, softcap)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return out, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``rowsum(dout · out)`` in fp32, ``[B, H, Sq]``."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _p_ds(q, k, v, dout, lse, delta, causal, window, softcap):
    """fp32 ``p`` and ``ds`` ``[B, KV, G, Sq, Sk]`` as ``_bwd_call``
    computes them: p from the logsumexp with the mask and the recomputed
    cap, ds = p (dp - delta) scale (1 - t^2). Also returns the cap's tanh
    (or None) and ``dp - delta``."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    s, t, mask = _logits(q, k, causal, window, softcap)
    p = torch.exp(s - lse.reshape(B, KV, G, Sq, 1))
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dg = dout.reshape(B, Sq, KV, G, D)
    dpd = torch.einsum("bqhgd,bkhd->bhgqk", dg.float(), v.float())
    dpd = dpd - delta.reshape(B, KV, G, Sq, 1)
    ds = p * dpd * (1.0 / float(D) ** 0.5)
    if t is not None:
        ds = ds * (1.0 - t * t)
    return p, ds, t, dpd


def _grads(p, ds, q, k, dout):
    """fp32 ``(dq, dk, dv)`` from ``p`` and ``ds``, each rounded to its
    partner's dtype before the product (as the TPU kernels round them);
    dk and dv are summed over each GQA group in fp32."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    dg = dout.reshape(B, Sq, KV, H // KV, D)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(), qg.float())
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dout.dtype).float(), dg.float())
    return dq.reshape(B, Sq, H, D), dk, dv


def _backward_plain(q, k, v, dout, lse, delta, causal, window, softcap):
    """What ``_bwd_call`` and ``_group_kv_grads`` compute, cast to the
    inputs' dtypes."""
    p, ds, _, _ = _p_ds(q, k, v, dout, lse, delta, causal, window, softcap)
    dq, dk, dv = _grads(p, ds, q, k, dout)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_magnitudes(q, k, v, out, lse, dout, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """``W`` for :func:`.attention.kernel_tolerance` when it holds a
    backward kernel's ``(dq, dk, dv)`` against the plain version's on the
    same bf16 inputs, out and lse: ``|kernel - plain| <= 2^-7 W + 2
    ulp(plain)`` per element, and the mean within ``2^-9 mean(W)``.

    Where the two sides round, and what each costs:

    - p and ds go to bf16 before their products, each side within 2^-8
      relative, so the rounded operands differ by 2^-7 of their magnitude
      plus whatever their fp32 values already differed by.
    - Those fp32 values differ because each side sums its D-long products
      (q.k, dO.V, and delta's dO.O) in its own order: each such sum is
      within ``gamma_D = D u / (1 - D u)`` (u = 2^-24) of its operands'
      absolute products, so two sides differ by twice that. On the scaled
      logit that is ``e_x = 2 gamma_D scale |q|.|k|`` (the cap only
      contracts it); p = exp(x - lse) then differs by ``e_p = e_x + 2^-20``
      relative (the exp and the subtraction); ``dp - delta`` by ``e_d = 2
      gamma_D (|dO|.|V| + |dO|.|O|)`` absolute — where dp and delta cancel
      (a row with a single live key has exact ds = 0) this term is all
      there is; the cap factor 1 - t^2 by ``2 e_x / cap``.
    - The fp32 sums of the products of the rounded operands then differ by
      at most 2^-7 times the sum of ``P = p (1 + 2^7 e_p)`` or
      ``E = |ds| (1 + 2^7 e_p) + 2^7 p scale (|1 - t^2| e_d + |dp - delta|
      2 e_x / cap)`` against the other operand's magnitudes:
      ``W_dq = E |k|``, ``W_dk = E^T |q|`` and ``W_dv = P^T |dO|`` (sums
      over the GQA group included); each side's final rounding of the
      gradient to bf16 adds half an ulp. Independent rounding errors
      mostly cancel in the mean, hence its tighter bound."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / float(D) ** 0.5
    u = D * 2.0 ** -24
    gamma = u / (1.0 - u)
    qa, ka, va, da, oa = (x.float().abs() for x in (q, k, v, dout, out))
    p, ds, t, dpd = _p_ds(q, k, v, dout, lse, _delta(out, dout), causal,
                          window, softcap)
    qg, dg = qa.reshape(B, Sq, KV, G, D), da.reshape(B, Sq, KV, G, D)
    e_x = torch.einsum("bqhgd,bkhd->bhgqk", qg, ka) * (2 * gamma * scale)
    e_d = torch.einsum("bqhgd,bkhd->bhgqk", dg, va)
    e_d += (da * oa).sum(-1).transpose(1, 2).reshape(B, KV, G, Sq, 1)
    e_d *= 2 * gamma
    grow = 1.0 + 2.0 ** 7 * (e_x + 2.0 ** -20)
    extra = (1.0 - t * t).abs() * e_d if t is not None else e_d
    if t is not None:
        extra += dpd.abs() * (2.0 / softcap) * e_x
    e = ds.abs() * grow + (2.0 ** 7 * scale) * p * extra
    return _grads(p * grow, e, qa, ka, da)


def flash_backward_reference(q, k, v, out, lse, dout, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """Plain backward: ``(dq, dk, dv)`` from the forward's output and
    logsumexp, exactly as the JAX package's backward kernels compute them."""
    return _backward_plain(q, k, v, dout, lse, _delta(out, dout), causal,
                           window, softcap)


# ----- kernel wrappers -----------------------------------------------------------


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  return_lse: bool = False):
    """Self-attention, q ``[B, Sq, H, D]``; k/v ``[B, Sk, KV, D]``. On a CUDA
    tensor it launches the kernel (bf16, D in 64/128/256) or raises; on a
    CPU tensor it runs the plain version. ``return_lse`` also returns the
    fp32 logsumexp ``[B, H, Sq]`` the backward needs."""
    B, Sq, H, D, Sk, KV = _check(q, k, v, causal, window)
    if not q.is_cuda:
        if return_lse:
            return flash_reference(q, k, v, causal, window, softcap)
        return reference_attention(q, k, v, causal=causal, window=window,
                                   logits_softcap=softcap)
    _check_cuda(q, k, v)
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim {D} not in {KERNEL_HEAD_DIMS}")
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _fwd_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Sk, H, KV, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window), float(softcap), 1.0 / float(D) ** 0.5,
        _stream(q),
    )
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_forward.launches += 1
    return (out, lse) if return_lse else out


flash_forward.launches = 0


def _bwd_args(q, k, v, dout, lse, delta, causal, window):
    """Checks and the shared leading arguments of both backward kernels;
    returns ``(shape, operands, strides)``, strides kept alive by the
    caller for the launch."""
    B, Sq, H, D, Sk, KV = _check(q, k, v, causal, window)
    _check_cuda(q, k, v, dout)
    if D == 256:
        raise NotImplementedError(
            "the flash backward kernels take head_dim 64 and 128; 256 is not "
            "ported yet (ROADMAP Queue 2 item 3)")
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash backward head_dim {D} not in {BWD_HEAD_DIMS}")
    if dout.shape != q.shape or lse.shape != (B, H, Sq) or delta.shape != (B, H, Sq):
        raise ValueError("dout must match q, lse and delta must be [B, H, Sq]")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("lse and delta are fp32")
    ops = [_kernel_operand(t) for t in (q, k, v, dout)]
    ops += [lse.contiguous(), delta.contiguous()]
    strides = (_L * 12)(*(s for t in ops[:4] for s in t.stride()[:3]))
    return (B, Sq, H, D, Sk, KV), ops, strides


def _launch_tail(shape, strides, causal, window, softcap, q):
    B, Sq, H, D, Sk, KV = shape
    return (B, Sq, Sk, H, KV, D, strides, int(causal), int(window),
            float(softcap), 1.0 / float(D) ** 0.5, _stream(q))


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                 window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """dq ``[B, Sq, H, D]`` from the logsumexp and ``delta`` (fp32
    ``[B, H, Sq]``). On a CUDA tensor it launches the dq kernel (bf16, D 64
    or 128) or raises; on a CPU tensor it runs the plain version."""
    if not q.is_cuda:
        return _backward_plain(q, k, v, dout, lse, delta, causal, window,
                               softcap)[0]
    shape, ops, strides = _bwd_args(q, k, v, dout, lse, delta, causal, window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _bwd_lib("flash_bwd_dq_bf16", 1)(
        *(t.data_ptr() for t in ops), dq.data_ptr(),
        *_launch_tail(shape, strides, causal, window, softcap, q))
    if err:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError {err}")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                  window: int = 0, softcap: float = 0.0):
    """``(dk, dv)``, each ``[B, Sk, KV, D]`` and summed over the q heads of
    each KV head. On a CUDA tensor it launches the dk/dv kernel (bf16, D 64
    or 128) or raises; on a CPU tensor it runs the plain version."""
    if not q.is_cuda:
        return _backward_plain(q, k, v, dout, lse, delta, causal, window,
                               softcap)[1:]
    shape, ops, strides = _bwd_args(q, k, v, dout, lse, delta, causal, window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _bwd_lib("flash_bwd_dkv_bf16", 2)(
        *(t.data_ptr() for t in ops), dk.data_ptr(), dv.data_ptr(),
        *_launch_tail(shape, strides, causal, window, softcap, q))
    if err:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: cudaError {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_backward(q, k, v, out, lse, dout, causal: bool = True,
                   window: int = 0, softcap: float = 0.0):
    """``(dq, dk, dv)`` of self-attention from the forward's output and
    logsumexp: on CUDA the two backward kernels (or an error), on the CPU
    the plain version. ``delta`` is a torch reduction, as it is XLA-side in
    the JAX package."""
    delta = _delta(out, dout)
    if not q.is_cuda:
        return _backward_plain(q, k, v, dout, lse, delta, causal, window,
                               softcap)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, window, softcap)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal, window, softcap)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's ``_flash`` custom
    VJP): the forward kernel, with the logsumexp only when an input needs a
    gradient, and the two backward kernels. Non-tensor arguments
    ``(causal, window, softcap)`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.opts = (causal, window, softcap)
        if not any(ctx.needs_input_grad[:3]):
            return flash_forward(q, k, v, causal, window, softcap)
        out, lse = flash_forward(q, k, v, causal, window, softcap,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, *ctx.opts)
        return dq, dk, dv, None, None, None
