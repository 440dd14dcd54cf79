"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward, with an
optional logsumexp) and ``csrc/flash_bwd.cu`` (dq; dk and dv per KV head),
their gates, their plain versions and the autograd function that joins
them (counterpart of ``kata_xpu_device_plugin_tpu/ops/flash.py``).

Eligibility (:func:`pick_block`, :func:`supports`) is decided exactly as
in the JAX package; the kernels pick their own tiles (the forward 128-row
blocks of two 64-row warpgroups over 64- or 128-key tiles,
:func:`fwd_tiles`; the backward 64-row blocks over 32- or 64-row tiles,
:func:`bwd_tiles`), since the TPU's 1024-row blocks do not fit a Hopper
SM. :func:`fwd_schedule` and :func:`bwd_schedule` model which tiles each
block visits, in order. The plain versions are
:func:`flash_reference` and :func:`flash_backward_reference`, taken only
for CPU tensors. Nonzero offsets and the logsumexp cotangent of the ring
API are not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .attention import NEG_INF, reference_attention

DEFAULT_BLOCK = 1024
KERNEL_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)


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


FWD_WG_ROWS = 64  # q rows of a forward warpgroup (flash_fwd.cu WG_ROWS)
FWD_WARPGROUPS = 2  # consumer warpgroups of a forward block (NWG)


def fwd_tiles(D: int) -> tuple:
    """``(q rows of a block, keys of a ring stage, ring stages)`` of the
    forward kernel at head_dim ``D`` (``BQ``, ``Cfg<D>::BK`` and
    ``Cfg<D>::STAGES`` in ``flash_fwd.cu``): fixed by the head width alone.
    At D = 256 a stage holds 64 keys, since O takes 128 registers a thread
    there."""
    return (FWD_WARPGROUPS * FWD_WG_ROWS, 64 if D == 256 else 128,
            4 if D == 64 else 2)


def fwd_schedule(Sq: int, Sk: int, H: int, KV: int, D: int,
                 causal: bool = True, window: int = 0, B: int = 1) -> list:
    """The forward kernel's tile schedule, as ``csrc/flash_fwd.cu`` runs
    it: its blocks in launch order, the q tiles with the longest causal key
    range first, then the batch rows, then the q heads (those of one KV
    head side by side). A block is a dict with ``row``, ``head``,
    ``kv_head``, ``q0``, ``loads`` (the ``(k0, rows)`` key tiles its ring fills, in order, with
    the rows read from k and v: a tile past the sequence's end is
    zero-filled, and the last tile ends at the last row's causal frontier
    when ``Sq == Sk``) and ``visits``, the ``(qw, k0, masked)``
    warpgroup tiles whose products run (``FWD_WG_ROWS`` q rows from ``qw``
    by a stage's keys from ``k0``) in loop order, each warpgroup's keys
    ascending. A warpgroup skips a tile with no live pair and rows past
    ``Sq``; ``masked`` says that the tile applies the mask, which holds
    exactly when one of its pairs (rows below ``Sq``) is masked."""
    BQ, NK, _ = fwd_tiles(D)
    W = FWD_WG_ROWS

    def key_range(q0, n):
        lo, hi = 0, Sk
        if causal:
            hi = min(Sk, Sq, q0 + n)
            if window > 0:
                lo = max(0, q0 - window + 1)
        return lo, hi

    def tile_live(qw, k0):
        ok = k0 + NK <= Sk
        if causal:
            ok = ok and k0 + NK - 1 <= qw
            if window > 0:
                ok = ok and k0 > min(qw + W, Sq) - 1 - window
        return ok

    nq = -(-Sq // BQ)
    blocks = []
    for z in range(nq):
        q0 = (nq - 1 - z) * BQ
        lo, hi = key_range(q0, BQ)
        k0s = range(lo // NK * NK, hi, NK)
        spans = [(qw, *key_range(qw, W)) for qw in range(q0, q0 + BQ, W)
                 if qw < Sq]
        visits = [(qw, k0, not tile_live(qw, k0)) for k0 in k0s
                  for qw, wlo, whi in spans if k0 < whi and k0 + NK > wlo]
        loads = [(k0, min(NK, Sk - k0)) for k0 in k0s]
        for b in range(B):
            for h in range(H):
                blocks.append({"row": b, "head": h, "kv_head": h // (H // KV),
                               "q0": q0, "loads": loads, "visits": visits})
    return blocks


BWD_TILE = 64  # q rows of a dq block, keys of a dk/dv block (flash_bwd.cu)


def bwd_tiles(D: int) -> tuple:
    """``(dq keys, dk/dv q rows)`` of a ring stage at head_dim ``D``
    (``Cfg<D>::DQ_BK`` and ``Cfg<D>::KV_BQ`` in ``flash_bwd.cu``)."""
    return (32 if D == 256 else 64), (64 if D == 64 else 32)


DKV_MIN_BLOCKS = 512  # dk/dv blocks to aim for before splitting the heads


def dkv_splits(B: int, Sk: int, H: int, KV: int, D: int) -> int:
    """Head groups of a dk/dv launch: the smallest divisor of the GQA
    group ``H / KV`` that gives at least ``DKV_MIN_BLOCKS`` blocks (else
    the whole group, one head a block). With more than one, each block sums
    its group's fp32 partial and a combine pass adds the groups up in
    order, so a grid of few KV heads and rows (MQA) still fills the card
    and its heaviest key tile is split. Fixed by the shapes alone, so a
    relaunch sums in the same order."""
    G = H // KV
    blocks = KV * B * -(-Sk // BWD_TILE) * (2 if D == 256 else 1)
    return next((d for d in range(1, G + 1)
                 if G % d == 0 and blocks * d >= DKV_MIN_BLOCKS), G)


def bwd_schedule(Sq: int, Sk: int, H: int, KV: int, D: int,
                 causal: bool = True, window: int = 0, B: int = 1) -> dict:
    """The backward kernels' tile schedule for one batch row of a launch of
    ``B`` rows, as ``csrc/flash_bwd.cu`` runs it: ``{"dq": blocks, "dkv":
    blocks}``, each list in launch order. A block is a dict with ``grads``
    (the gradients it sums), the rows it owns (``head`` and ``q0`` for dq;
    ``kv_head``, ``k0`` and its head group ``split`` for dk/dv) and
    ``visits``, the ``(q0, k0, q head)`` tiles in the order it adds them
    up: dq tiles are ``BWD_TILE`` q rows by ``bwd_tiles(D)[0]`` keys, dk/dv
    tiles ``bwd_tiles(D)[1]`` q rows by ``BWD_TILE`` keys. dq: one block
    per (q tile, q head), the q tiles with the longest key range first and
    the heads of one KV head side by side; dk/dv: one block per (key tile,
    head group of :func:`dkv_splits`, KV head), lowest key tile first,
    visiting head-major the q tiles that can see the tile; at D = 256 two
    blocks each, one for dv, one for dk. Head groups' partials are summed
    in ``split`` order."""
    T = BWD_TILE
    NK, NQ = bwd_tiles(D)
    G = H // KV
    nq, nk = -(-Sq // T), -(-Sk // T)
    dq = []
    for z in range(nq):
        q0 = (nq - 1 - z) * T
        k_begin, k_end = 0, Sk
        if causal:
            k_end = min(Sk, q0 + T)
            if window > 0 and q0 - window + 1 > 0:
                k_begin = (q0 - window + 1) // NK * NK
        for h in range(H):
            dq.append({"grads": ("dq",), "head": h, "q0": q0, "visits": [
                (q0, k0, h) for k0 in range(k_begin, k_end, NK)]})
    dkv = []
    nsplit = dkv_splits(B, Sk, H, KV, D)
    Gs = G // nsplit
    modes = (("dv",), ("dk",)) if D == 256 else (("dk", "dv"),)
    for kt in range(nk):
        k0 = kt * T
        q_begin, q_end = 0, Sq
        if causal:
            q_begin = k0 // NQ * NQ
            if window > 0:
                q_end = min(Sq, k0 + T - 1 + window)
        n_qt = max(0, -(-(q_end - q_begin) // NQ))
        for split in range(nsplit):
            for grads in modes:
                for kvh in range(KV):
                    h0 = kvh * G + split * Gs
                    dkv.append({
                        "grads": grads, "kv_head": kvh, "k0": k0,
                        "split": split, "visits": [
                            (q_begin + (i % n_qt) * NQ, k0, h0 + i // n_qt)
                            for i in range(Gs * n_qt)]})
    return {"dq": dq, "dkv": dkv}


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


def _bwd_lib(name: str):
    """dq: 8 pointers (the last ``out``), 6 ints; dk/dv: 9 pointers (the
    last the partials' scratch), 7 ints (the last the head groups)."""
    n_ptr, n_int = (8, 6) if name == "flash_bwd_dq_bf16" else (9, 7)
    return _fn("flash_bwd", name, [_P] * n_ptr + [_I] * n_int
               + [ctypes.POINTER(_L), _I, _I, _F, _F, _P])


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """The kernels read rows with 16-byte loads: the last dim contiguous,
    every stride a multiple of 8 elements, the base 16-byte aligned.
    Anything else (never the transformer's own views) is copied."""
    ok = (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """lse and delta rows are read in 16-byte copies: a contiguous tensor
    whose base is not 16-byte aligned (an offset view) is copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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


def _bwd_args(q, k, v, dout, lse, delta, causal, window, out=None):
    """Checks and the shared leading arguments of both backward kernels;
    returns ``(shape, operands, strides)``, strides (of q, k, v, dout and
    ``out``, zeros without it) kept alive by the caller for the launch."""
    B, Sq, H, D, Sk, KV = _check(q, k, v, causal, window)
    _check_cuda(q, k, v, dout)
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash backward head_dim {D} not in {BWD_HEAD_DIMS}")
    if dout.shape != q.shape or lse.shape != (B, H, Sq) or delta.shape != (B, H, Sq):
        raise ValueError("dout must match q, lse and delta must be [B, H, Sq]")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("lse and delta are fp32")
    ops = [_kernel_operand(t) for t in (q, k, v, dout)]
    ops += [_aligned(lse.contiguous()), _aligned(delta.contiguous())]
    tail = (0, 0, 0) if out is None else out.stride()[:3]
    strides = (_L * 15)(*(s for t in ops[:4] for s in t.stride()[:3]), *tail)
    return (B, Sq, H, D, Sk, KV), ops, strides


def _launch_tail(shape, strides, causal, window, softcap, q, *extra):
    B, Sq, H, D, Sk, KV = shape
    return (B, Sq, Sk, H, KV, D, *extra, strides, int(causal), int(window),
            float(softcap), 1.0 / float(D) ** 0.5, _stream(q))



def _launch_dq(q, k, v, dout, lse, delta, causal, window, softcap, out=None):
    """The dq kernel; with ``out`` (the forward's output) it forms
    ``delta`` itself and writes it into ``delta``."""
    if out is not None:
        _check_cuda(out)
        if out.shape != q.shape:
            raise ValueError("out must match q")
        out = _kernel_operand(out)
    shape, ops, strides = _bwd_args(q, k, v, dout, lse, delta, causal, window,
                                    out)
    if out is not None and ops[5] is not delta:
        raise ValueError("delta to write must be a contiguous, aligned fp32 "
                         "[B, H, Sq]")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _bwd_lib("flash_bwd_dq_bf16")(
        *(t.data_ptr() for t in ops), dq.data_ptr(),
        None if out is None else out.data_ptr(),
        *_launch_tail(shape, strides, causal, window, softcap, q))
    if err:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError {err}")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                 window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """dq ``[B, Sq, H, D]`` from the logsumexp and ``delta`` (fp32
    ``[B, H, Sq]``). On a CUDA tensor it launches the dq kernel (bf16, D
    64, 128 or 256) or raises; on a CPU tensor it runs the plain version."""
    if not q.is_cuda:
        return _backward_plain(q, k, v, dout, lse, delta, causal, window,
                               softcap)[0]
    return _launch_dq(q, k, v, dout, lse, delta, causal, window, softcap)


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                  window: int = 0, softcap: float = 0.0):
    """``(dk, dv)``, each ``[B, Sk, KV, D]`` and summed over the q heads of
    each KV head. On a CUDA tensor it launches the dk/dv kernel (bf16, D 64,
    128 or 256) or raises; on a CPU tensor it runs the plain version."""
    if not q.is_cuda:
        return _backward_plain(q, k, v, dout, lse, delta, causal, window,
                               softcap)[1:]
    shape, ops, strides = _bwd_args(q, k, v, dout, lse, delta, causal, window)
    B, Sq, H, D, Sk, KV = shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    nsplit = dkv_splits(B, Sk, H, KV, D)
    part = (torch.empty((2, nsplit) + tuple(k.shape), dtype=torch.float32,
                        device=k.device) if nsplit > 1 else None)
    err = _bwd_lib("flash_bwd_dkv_bf16")(
        *(t.data_ptr() for t in ops), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(),
        *_launch_tail(shape, strides, causal, window, softcap, q, nsplit))
    if err:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: cudaError {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_backward(q, k, v, out, lse, dout, causal: bool = True,
                   window: int = 0, softcap: float = 0.0):
    """``(dq, dk, dv)`` of self-attention from the forward's output and
    logsumexp: on CUDA the two backward kernels (or an error), on the CPU
    the plain version. ``delta = rowsum(dout * out)`` is an XLA-side
    reduction in the JAX package; on CUDA the dq kernel forms it from
    ``out`` (in fp32, as :func:`_delta` does) and hands it to dk/dv."""
    if not q.is_cuda:
        return _backward_plain(q, k, v, dout, lse, _delta(out, dout), causal,
                               window, softcap)
    B, Sq, H, _ = q.shape
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = _launch_dq(q, k, v, dout, lse, delta, causal, window, softcap, out)
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
