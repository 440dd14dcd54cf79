#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card (``nvidia-smi`` name and power limit) and CUDA version;
2. build  — compile every kernel under ``kata_xpu_device_plugin_tpu_torch/csrc``;
3. check  — each kernel against its plain PyTorch version on the card, bf16,
   at the main paths' shapes and layouts, within the per-element and mean
   bounds of ``ops.attention.kernel_tolerance`` (for the backward kernels
   with the magnitudes ``ops.flash.backward_magnitudes`` derives); the
   forward's logsumexp in fp32. The paged decode kernel walks permuted,
   non-contiguous tables with unmapped entries, ragged positions and a dead
   lane, at Gemma-2B and Llama-3-8B head shapes, single-query and as spans
   of 4 and 8 rows with ragged query lengths (real rows within the bound
   and bit-equal to a single-query launch at the row's position, padding
   rows finite and within max|V|); the dense decode kernel at five shared
   positions;
4. serve  — full-width Gemma-2B (random bf16 weights, fused) served by
   ``GenerationServer`` (int8 KV, chunk 8): 16 requests; launch counts of
   both kernels reset just before and read just after; then two requests
   through the kernel path and the plain path: every layer's kernel call
   held against the plain version on its own inputs, and the logits held
   against the plain path's (``crosscheck``);
5. paged  — the same model served over a paged block pool:
   ``GenerationServer(max_batch=16, kv_pool_tokens=8000, kv_block_size=16)``,
   32 requests; every decode step walks the lanes' real block tables with
   the paged kernel; the pool comes under pressure, so lanes are preempted,
   spilled and resumed. Asserted: every budget returned, at least one
   preemption, an empty pool at the end, more than 8 lanes at once. Then
   one round of a loaded paged server with every layer's kernel call held
   against the plain version on its own inputs (``paged_crosscheck``), and
   the slotted server on the same requests for the token-match fraction;
6. generate — ``generate()`` at full width, B=8, prompt 128, 64 steps, bf16
   cache, under ``KATA_TPU_DECODE_KERNEL=1``: 18 x 63 launches of the dense
   decode kernel, each layer of the first decode step held against the
   plain version, and the token-match fraction against the run without
   the opt-in (which launches the dense kernel no time);
7. train  — Llama-3-8B at its published widths with 8 of its 32 layers
   (one card's memory), random fp32 parameters from seed 0, bf16 compute:
   ``make_train_step`` and ``fit`` for 6 AdamW steps on one repeated
   batch (B=2, S=2048); launch counts reset just before and read just
   after (8 forward, 8 dq and 8 dk/dv launches a step); the loss must be
   finite and fall. Then ``train_crosscheck``: one ``next_token_loss``
   backward at 2 layers, B=1, through the kernels (each layer's forward
   and backward kernel call held against the plain version on its own
   inputs) and through ``reference_attention``; the loss difference and
   the cosine of the whole gradient are printed.

Then the ``{"kernels": [...]}`` line and, last, the device line.
``--profile`` adds a ``torch.profiler`` window over two decode rounds of a
loaded server and one over a train step after the run. Any failed
phase raises: the script exits non-zero and prints no result. Without CUDA,
or outside a checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "kata_xpu_device_plugin_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel against plain version: attention.kernel_tolerance, derived from
# where the two sides round to bf16. End to end, the kernel path's logits
# against the plain path's: max |difference| within these multiples of the
# plain logits' RMS. They are set from readings on an H100 (prefill 0.53-
# 0.55, first decode step 0.21-0.25; PERF.md), not derived: the random
# weights carry each layer's rounding difference on through 18 layers.
LOGIT_BOUND = {"prefill": 0.75, "decode": 0.35}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(name: str, out, ref, mag) -> dict:
    """Hold a kernel's output against the plain version's on the same
    inputs; ``mag`` is the plain version applied to |v|."""
    from kata_xpu_device_plugin_tpu_torch.ops.attention import kernel_tolerance

    res = {"case": name, **kernel_tolerance(out, ref, mag)}
    if not res.pop("ok"):
        raise AssertionError(f"{name}: kernel disagrees with plain version {res}")
    return res


def v_abs(v):
    """|v| for a bf16 tensor or an int8 QTensor (whose scales are >= 0)."""
    from kata_xpu_device_plugin_tpu_torch.ops.quant import QTensor

    return QTensor(v.q.abs(), v.scale) if isinstance(v, QTensor) else v.abs()


# ----- phases ---------------------------------------------------------------


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, cuda=torch.version.cuda,
         torch=torch.__version__, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from kata_xpu_device_plugin_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(_build.sources())
    regs = {
        n: [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
        for n, log in _build.build_log.items()
    }
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         sources=_build.sources(), ptxas=regs)


def flash_case(name, B, S, H, KV, D, window=0, softcap=0.0, timed=False):
    """q/k/v are slices of one fused ``[B, S, (H + 2 KV) D]`` projection,
    the strided layout the transformer's fused ``wqkv`` hands the kernel."""
    import torch
    import torch.nn.functional as F

    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward

    g = torch.Generator(device="cuda").manual_seed(B * S + H + D)
    qkv = torch.randn(B, S, (H + 2 * KV) * D, generator=g, device="cuda",
                      dtype=torch.bfloat16)
    q = qkv[..., : H * D].reshape(B, S, H, D)
    k = qkv[..., H * D: (H + KV) * D].reshape(B, S, KV, D)
    v = qkv[..., (H + KV) * D:].reshape(B, S, KV, D)
    kw = dict(window=window, logits_softcap=softcap)
    out = flash_forward(q, k, v, window=window, softcap=softcap)
    ref = reference_attention(q, k, v, **kw)
    mag = reference_attention(q.float(), k.float(), v.abs().float(), **kw)
    torch.cuda.synchronize()
    res = check(name, out, ref, mag)
    del mag
    if timed:
        res["ms"] = time_ms(lambda: flash_forward(q, k, v), 10)
        res["plain_ms"] = time_ms(lambda: reference_attention(q, k, v), 3, 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        flops = 4.0 * B * H * D * S * (S + 1) / 2
        nbytes = 2.0 * B * S * D * (2 * H + 2 * KV)
        res["bound_ms"] = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
        res["bound_by"] = ("operations" if flops / PEAK_BF16_FLOPS
                           > nbytes / PEAK_HBM_BYTES else "bytes")
    emit("check", kernel="flash_fwd", B=B, S=S, H=H, KV=KV, D=D,
         window=window, softcap=softcap, **res)
    return res


def decode_bound(keys: float, B, SQ, H, KV, D, nb, quantized, flops) -> dict:
    """The least time the card could take for a paged decode call that must
    read ``keys`` K rows and as many V rows once (payload and, for int8,
    scale), q and the tables once, and write the output once."""
    row_bytes = D * (1 if quantized else 2) + (4 if quantized else 0)
    nbytes = 2 * keys * KV * row_bytes + 2 * 2 * B * SQ * H * D + 4 * B * (nb + 2)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def decode_case(name, B, H, KV, D, bs, quantized, max_len=2048, timed=False,
                dead=False):
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        paged_decode_attention,
        paged_decode_reference,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(bs + B + int(quantized))
    nb = max_len // bs
    nt = (2 + B * nb) * bs
    q = torch.randn(B, 1, H, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pk = torch.randn(1, nt, KV, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pv = torch.randn(1, nt, KV, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pk[0, :bs] = 0.0
    pv[0, :bs] = 0.0  # block 0 is the ZERO block
    pos = torch.randint(0, max_len, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    if dead:
        pos[-1] = 10_000  # a dead lane's stale position, past its table
    perm = torch.randperm(B * nb, generator=g, device="cuda").to(torch.int32) + 2
    tables = perm.reshape(B, nb).clone()
    live = torch.arange(nb, device="cuda")[None, :] <= (pos // bs)[:, None]
    tables = torch.where(live, tables, torch.zeros_like(tables))  # unmapped: ZERO
    k, v = (quantize_kv(pk), quantize_kv(pv)) if quantized else (pk, pv)
    kw = dict(block_size=bs, paged_len=max_len)
    out = paged_decode_attention(q, k, v, tables, pos, **kw)
    ref = paged_decode_reference(q, k, v, tables, pos, **kw)
    mag = paged_decode_reference(q.float(), k, v_abs(v), tables, pos, **kw)
    torch.cuda.synchronize()
    res = check(name, out, ref, mag)
    if timed:
        res["ms"] = time_ms(lambda: paged_decode_attention(q, k, v, tables, pos, **kw), 20)
        res["plain_ms"] = time_ms(
            lambda: paged_decode_reference(q, k, v, tables, pos, **kw), 5, 1)
        res["library_ms"] = None  # no single PyTorch call computes it
        keys = float((pos.clamp(max=max_len - 1) + 1).sum())
        res.update(decode_bound(keys, B, 1, H, KV, D, nb, quantized,
                                4.0 * H * D * keys))
    emit("check", kernel="paged_decode", B=B, H=H, KV=KV, D=D, bs=bs,
         int8=quantized, pos=pos.tolist(), **res)
    return res


def decode_mq_case(name, B, H, KV, D, bs, quantized, SQ, max_len=2048,
                   timed=False):
    """The multi-query form: spans of ``SQ`` right-aligned rows with ragged
    query lengths (``q_len = 1`` lanes beside full-width ones) through
    permuted tables; the last lane is dead. Real rows are held to the plain
    version and must equal, bit for bit, a single-query launch at the row's
    own position; padding rows must be finite and within max|V|."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        paged_decode_attention,
        paged_decode_reference,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    g = torch.Generator(device="cuda").manual_seed(bs + B + SQ + int(quantized))
    nb = max_len // bs
    nt = (2 + B * nb) * bs
    q = torch.randn(B, SQ, H, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pk = torch.randn(1, nt, KV, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pv = torch.randn(1, nt, KV, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pk[0, :bs] = 0.0
    pv[0, :bs] = 0.0  # block 0 is the ZERO block
    pos = torch.randint(SQ - 1, max_len, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    pos[0] = SQ - 1  # the shortest span that fits
    pos[-1] = 10_000  # dead lane
    q_lens = torch.randint(1, SQ + 1, (B,), generator=g, device="cuda",
                           dtype=torch.int32)
    q_lens[0], q_lens[1], q_lens[2] = SQ, 1, SQ
    perm = torch.randperm(B * nb, generator=g, device="cuda").to(torch.int32) + 2
    tables = perm.reshape(B, nb).clone()
    live = torch.arange(nb, device="cuda")[None, :] <= (pos // bs)[:, None]
    tables = torch.where(live, tables, torch.zeros_like(tables))  # unmapped: ZERO
    k, v = (quantize_kv(pk), quantize_kv(pv)) if quantized else (pk, pv)
    kw = dict(block_size=bs, paged_len=max_len)
    out = paged_decode_attention(q, k, v, tables, pos, q_lens, **kw)
    ref = paged_decode_reference(q, k, v, tables, pos, q_lens, **kw)
    mag = paged_decode_reference(q.float(), k, v_abs(v), tables, pos, q_lens, **kw)
    torch.cuda.synchronize()
    real = torch.arange(SQ, device="cuda")[None, :] >= SQ - q_lens[:, None]
    real[-1] = False  # the dead lane's span straddles nothing real
    res = check(name, out[real], ref[real], mag[real])
    v_max = float(dequantize_kv(v, torch.bfloat16).float().abs().max())
    pad_max = float(out.float().abs().max())
    if not (math.isfinite(pad_max) and pad_max <= v_max):
        raise AssertionError(f"{name}: padding rows not finite within max|V| "
                             f"({pad_max} > {v_max})")
    for j in range(SQ):
        one = paged_decode_attention(q[:, j:j + 1].contiguous(), k, v, tables,
                                     pos - (SQ - 1) + j, **kw)
        if not torch.equal(out[real[:, j], j], one[real[:, j], 0]):
            raise AssertionError(f"{name}: row {j} differs from the single-"
                                 "query launch at its position")
    res["rows_bit_equal_single_query"] = int(real.sum())
    if timed:
        res["ms"] = time_ms(lambda: paged_decode_attention(
            q, k, v, tables, pos, q_lens, **kw), 20)
        res["plain_ms"] = time_ms(lambda: paged_decode_reference(
            q, k, v, tables, pos, q_lens, **kw), 5, 1)
        res["library_ms"] = None
        live_pos = pos[:-1].float()
        keys = float((live_pos + 1).sum())
        row_pos = (live_pos[:, None] - (SQ - 1)
                   + torch.arange(SQ, device="cuda")[None, :])
        pairs = float(((row_pos + 1) * real[:-1]).sum())
        res.update(decode_bound(keys, B, SQ, H, KV, D, nb, quantized,
                                4.0 * H * D * pairs))
    emit("check", kernel="paged_decode", form="multi_query", SQ=SQ, B=B, H=H,
         KV=KV, D=D, bs=bs, int8=quantized, pos=pos.tolist(),
         q_lens=q_lens.tolist(), **res)
    return res


def dense_case(name, B, S, H, KV, D, pos, timed=False):
    """The lock-step dense kernel: one token per row into a dense bf16 cache
    read in place, one device-scalar position for the whole batch."""
    import torch
    import torch.nn.functional as F

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        decode_attention,
        decode_attention_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(S + H + D + pos)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q, k, v = rnd(B, 1, H, D), rnd(B, S, KV, D), rnd(B, S, KV, D)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    out = decode_attention(q, k, v, p)
    ref = decode_attention_reference(q, k, v, p)
    mag = decode_attention_reference(q.float(), k.float(), v.abs().float(), p)
    torch.cuda.synchronize()
    res = check(name, out, ref, mag)
    if timed:
        res["ms"] = time_ms(lambda: decode_attention(q, k, v, p), 20)
        res["plain_ms"] = time_ms(lambda: decode_attention_reference(q, k, v, p), 5, 1)
        qt = q.transpose(1, 2)
        kt, vt = (t[:, :pos + 1].transpose(1, 2) for t in (k, v))
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True), 20)
        nbytes = 2 * 2.0 * B * (pos + 1) * KV * D + 2 * 2.0 * B * H * D + 4
        flops = 4.0 * B * H * D * (pos + 1)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
        res.update(bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops > t_bytes else "bytes")
    emit("check", kernel="dense_decode", B=B, S=S, H=H, KV=KV, D=D, pos=pos, **res)
    return res


# The forward's logsumexp against the plain version's, fp32: both form it
# from fp32 logits of the same bf16 inputs and differ only in summation
# order (~1e-6 relative); a masking or scaling fault moves it by O(1).
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


def check_lse(name: str, lse, ref) -> float:
    import torch

    err = float((lse - ref).abs().max())
    if not (math.isfinite(err) and torch.allclose(lse, ref, **LSE_TOL)):
        raise AssertionError(f"{name}: logsumexp disagrees with plain ({err})")
    return err


def check_grads(name: str, got, want, mags) -> dict:
    """dq, dk and dv of a backward kernel call against the plain version's
    on the same inputs, within the bound ``flash.backward_magnitudes``
    derives; returns one result per gradient."""
    return {g: check(f"{name} {g}", a, b, m)
            for g, a, b, m in zip(("dq", "dk", "dv"), got, want, mags)}


def bwd_case(name, B, S, H, KV, D, causal=True, window=0, softcap=0.0,
             timed=False):
    """The forward with its logsumexp, then the two backward kernels, on
    contiguous ``[B, S, heads, D]`` q/k/v and dout (the training layout:
    q and k come out of rope, v out of its own projection)."""
    import torch
    import torch.nn.functional as F

    from kata_xpu_device_plugin_tpu_torch.ops import flash

    g = torch.Generator(device="cuda").manual_seed(7 * B * S + H + KV + D)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q, k, v, do = rnd(B, S, H, D), rnd(B, S, KV, D), rnd(B, S, KV, D), rnd(B, S, H, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash.flash_forward(q, k, v, return_lse=True, **kw)
    ref_out, ref_lse = flash.flash_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    lse_err = check_lse(name, lse, ref_lse)
    del ref_out, ref_lse
    delta = flash._delta(out, do)
    got = (flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
           *flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    want = flash.flash_backward_reference(q, k, v, out, lse, do, **kw)
    mags = flash.backward_magnitudes(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    res = check_grads(name, got, want, mags)
    del want, mags
    row = {"dq": {"case": name, **res["dq"]},
           "dkv": {"case": name,
                   **{f: max(res["dk"][f], res["dv"][f]) for f in
                      ("max_abs_err", "mean_abs_err", "max_err_over_bound")},
                   "mean_bound": min(res["dk"]["mean_bound"],
                                     res["dv"]["mean_bound"])}}
    if timed:
        ms_dq = time_ms(lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw), 10)
        ms_dkv = time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw), 10)
        plain = time_ms(lambda: flash.flash_backward_reference(
            q, k, v, out, lse, do, **kw), 3, 1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                enable_gqa=True)
        do_t = do.transpose(1, 2)
        library = time_ms(lambda: torch.autograd.grad(
            o_sdpa, (qt, kt, vt), do_t, retain_graph=True), 10)
        pairs = B * H * (S * (S + 1) / 2 if causal else S * S)
        in_bytes = 2.0 * B * S * D * (2 * H + 2 * KV) + 8.0 * B * H * S
        for key, ms, products, out_bytes in (
                ("dq", ms_dq, 3, 2.0 * B * S * H * D),
                ("dkv", ms_dkv, 4, 4.0 * B * S * KV * D)):
            flops = products * 2.0 * D * pairs
            nbytes = in_bytes + out_bytes
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
            row[key].update(ms=ms, plain_ms=plain, library_ms=library,
                            bound_ms=1e3 * max(t_ops, t_bytes),
                            bound_by="operations" if t_ops > t_bytes else "bytes")
    timing = {f"{k_}_{f}": row[k_][f] for k_ in ("dq", "dkv") for f in
              ("ms", "plain_ms", "library_ms", "bound_ms") if f in row[k_]}
    emit("check", kernel="flash_bwd", B=B, S=S, H=H, KV=KV, D=D, causal=causal,
         window=window, softcap=softcap, lse_max_abs_err=lse_err,
         **{k_: {f: v_ for f, v_ in r.items() if f != "case"}
            for k_, r in res.items()}, **timing)
    return row


def phase_checks() -> dict:
    results = {"flash_fwd": [], "paged_decode": [], "dense_decode": [],
               "flash_bwd_dq": [], "flash_bwd_dkv": []}
    f = results["flash_fwd"]
    for B in (1, 8):  # the serving run's prefill groups: N = 1-8 at S 128-1024
        for S in (128, 256):
            f.append(flash_case(f"gemma2b B{B} S{S}", B, S, 8, 1, 256))
    f.append(flash_case("gemma2b B4 S512", 4, 512, 8, 1, 256))
    f.append(flash_case("gemma2b B4 S1024", 4, 1024, 8, 1, 256, timed=True))
    f.append(flash_case("gemma2b B4 S2048", 4, 2048, 8, 1, 256))
    f.append(flash_case("llama3-8b B2 S2048", 2, 2048, 32, 8, 128))
    f.append(flash_case("window+softcap", 2, 256, 4, 2, 128, window=64,
                        softcap=50.0))
    d = results["paged_decode"]
    d.append(decode_case("gemma2b int8 bs128", 8, 8, 1, 256, 128, True, timed=True))
    d.append(decode_case("gemma2b bf16 bs128", 8, 8, 1, 256, 128, False))
    d.append(decode_case("gemma2b int8 bs16", 8, 8, 1, 256, 16, True))
    d.append(decode_case("gemma2b bf16 bs16", 8, 8, 1, 256, 16, False))
    tiles = {}
    for model, (H, KV, D) in (("gemma2b", (8, 1, 256)), ("llama3-8b", (32, 8, 128))):
        for bs in (16, 128):
            for quantized in (True, False):
                kind = "int8" if quantized else "bf16"
                # Timed extras (not the kernels line's case): the serving
                # shape at the paged pool's tile 16 against tile 128.
                timed = model == "gemma2b" and quantized
                c = decode_case(f"{model} {kind} bs{bs} dead lane", 8, H, KV, D,
                                bs, quantized, dead=True, timed=timed)
                if timed:
                    tiles[f"bs{bs}_ms"] = c.pop("ms")
                    for f in ("plain_ms", "library_ms", "bound_ms", "bound_by"):
                        tiles[f"bs{bs}_{f}"] = c.pop(f)
                d.append(c)
                for SQ in (4, 8):
                    c = decode_mq_case(f"{model} {kind} bs{bs} SQ{SQ}", 8, H, KV,
                                       D, bs, quantized, SQ,
                                       timed=timed and SQ == 8 and bs == 16)
                    if "ms" in c:
                        tiles.update({f"sq8_bs16_{f}": c.pop(f) for f in (
                            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
                    d.append(c)
    emit("paged_decode_tiles", shape="B=8 H=8 KV=1 D=256 int8, max_len 2048, "
         "ragged pos, one dead lane", **tiles)
    results["paged_decode_extra"] = tiles
    n = results["dense_decode"]
    for pos in (0, 127, 128, 1000, 2047):
        n.append(dense_case(f"gemma2b B8 S2048 pos{pos}", 8, 2048, 8, 1, 256, pos,
                            timed=pos == 2047))
    for pos in (5, 2047):
        n.append(dense_case(f"llama3-8b B8 S2048 pos{pos}", 8, 2048, 32, 8, 128,
                            pos))
    bwd = [  # llama3-8b widths unless the case says otherwise
        bwd_case("llama3-8b train B2 S2048", 2, 2048, 32, 8, 128, timed=True),
        bwd_case("llama3-8b B1 S128", 1, 128, 32, 8, 128),
        bwd_case("llama3-8b B1 S256", 1, 256, 32, 8, 128),
        bwd_case("mqa H8 KV1", 2, 256, 8, 1, 128),
        bwd_case("non-causal", 2, 256, 8, 2, 128, causal=False),
        bwd_case("window64+softcap50", 2, 256, 8, 2, 128, window=64,
                 softcap=50.0),
        bwd_case("D64", 2, 256, 8, 2, 64),
    ]
    results["flash_bwd_dq"] = [r["dq"] for r in bwd]
    results["flash_bwd_dkv"] = [r["dkv"] for r in bwd]
    return results


KERNEL_CLASSES = ("paged_decode", "dense_decode", "flash_fwd", "flash_bwd_dq",
                  "flash_bwd_dkv")


def profiled(window: str, fn) -> None:
    """Run ``fn`` under ``torch.profiler`` and print where its device time
    goes: summed per class (this repository's kernels, cuBLAS GEMMs,
    everything else) and per kernel name, against the host wall."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "device_time_total", None) or e.cuda_time_total

    classes = dict.fromkeys(KERNEL_CLASSES + ("gemm", "other"), 0.0)
    for e in kernels:
        name = e.key.lower()
        cls = next((c for c in KERNEL_CLASSES if c in name), None) or (
            "gemm" if any(t in name for t in ("gemm", "gemv", "sm90", "cutlass",
                                               "cublas", "nvjet")) else "other")
        classes[cls] += dev_us(e) / 1e3
    busy = sum(classes.values())
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    emit("profile", window=window,
         wall_ms=round(wall * 1e3, 3), device_busy_ms=round(busy, 3),
         device_idle_share=round(1 - busy / (wall * 1e3), 4),
         by_class_ms={k: round(v, 3) for k, v in classes.items()},
         top=[{"kernel": e.key[:80], "ms": round(dev_us(e) / 1e3, 3),
               "count": e.count} for e in top])


def profile_rounds(params, cfg, kw, rng, lanes: int = 8) -> None:
    """Where a decode round's device time goes: ``lanes`` requests admitted,
    then two lock-step rounds (16 decode steps) under the profiler."""
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    srv = GenerationServer(params, cfg, **kw)
    for n in rng.integers(500, 1001, lanes):
        srv.submit(rng.integers(0, cfg.vocab_size, n), 64)
    srv.step()  # admission of every request the server holds, plus one round
    busy = srv.stats()["lanes_busy_peak"]

    def rounds():
        srv.step()
        srv.step()

    arena = (f"paged pool, tile {kw['kv_block_size']}" if "kv_pool_tokens" in kw
             else "slotted arena")
    profiled(f"2 decode rounds (16 steps), {arena}, {busy} of "
             f"{kw['max_batch']} lanes busy, pos 500-1100", rounds)


def crosscheck(params, cfg, prompt, buckets, max_len: int) -> dict:
    """One request through the kernel path and the plain path.

    Inside the model, each layer's kernel call (prefill, then the first
    decode step) is held against the plain version on the same inputs —
    the main path's own shapes and strided layouts — with
    ``attention.kernel_tolerance``. End to end, the kernel path's
    last-position prefill logits and first decode step's logits are held
    against the plain path's, within LOGIT_BOUND x the plain logits' RMS;
    both decode steps start from the kernel path's caches, so the decode
    comparison sees only the decode attention. Greedy agreement over 16
    more steps is printed, not asserted: random weights make near-ties."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        _decode_scan,
        forward,
        prefill_batch,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import attention
    from kata_xpu_device_plugin_tpu_torch.ops.quant import dequantize_kv

    ref = attention.reference_attention
    kernel_fn = attention.make_decode_attn_fn(cfg, arena_len=max_len, device="cuda")
    layer_checks = {"prefill": [], "decode": []}

    def checked_flash(q, k, v, **kw):
        out = attention.flash_attention(q, k, v, **kw)
        mag = ref(q.float(), k.float(), v.abs().float(), **kw)
        layer_checks["prefill"].append(check("layer", out, ref(q, k, v, **kw), mag))
        return out

    def checked_decode(q, ck, cv, tables, pos):
        out = kernel_fn(q, ck, cv, tables, pos)
        plain = ref(q, dequantize_kv(ck, q.dtype), dequantize_kv(cv, q.dtype),
                    q_offset=pos)
        mag = ref(q.float(), dequantize_kv(ck, torch.float32),
                  dequantize_kv(v_abs(cv), torch.float32), q_offset=pos)
        layer_checks["decode"].append(check("layer", out, plain, mag))
        return out

    n = len(prompt)
    pad = next(b for b in buckets if b >= n)
    toks = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    toks[0, :n] = torch.from_numpy(np.asarray(prompt, np.int32))
    tl = torch.tensor([n], dtype=torch.int32)
    ck, lk, pos = prefill_batch(params, toks, cfg, max_len, tl, attn_fn=checked_flash,
                                kv_quantized=True)
    _, lp, _ = prefill_batch(params, toks, cfg, max_len, tl, attn_fn=ref,
                             kv_quantized=True)
    first = torch.argmax(lk, -1).to(torch.int32)

    def step(caches, fn):
        logits, _ = forward(params, first[:, None], cfg, attn_fn=ref,
                            positions=pos[:, None], kv_caches=caches,
                            cache_offset=pos, decode_kernel_fn=fn)
        return logits[:, -1]

    cd = tuple(type(c)(*(t.clone() for t in c)) for c in ck)
    dk, dp = step(ck, checked_decode), step(cd, None)
    nxt = torch.argmax(dk, -1).to(torch.int32)
    gk = _decode_scan(params, ck, nxt, pos + 1, cfg, 16, attn_fn=ref,
                      decode_kernel_fn=kernel_fn)
    gp = _decode_scan(params, cd, nxt, pos + 1, cfg, 16, attn_fn=ref)
    row = {"prompt_len": n, "logit_bound_x_rms": LOGIT_BOUND}
    for what, got, want in (("prefill", lk, lp), ("decode", dk, dp)):
        cases = layer_checks[what]
        row[f"{what}_layers_checked"] = len(cases)
        row[f"{what}_layer_max_err_over_bound"] = max(
            c["max_err_over_bound"] for c in cases)
        row[f"{what}_logit_err"] = float((got - want).abs().max())
        row[f"{what}_logit_rms"] = float(want.square().mean().sqrt())
    row["greedy_agreement_16"] = float((gk == gp).float().mean())
    emit("crosscheck", **row)
    return row


def assert_crosscheck(row: dict, n_layers: int) -> None:
    for what in ("prefill", "decode"):
        if row[f"{what}_layers_checked"] != n_layers:
            raise AssertionError(f"{what}: {row[f'{what}_layers_checked']} layer "
                                 f"checks, want {n_layers}")
        err, rms = row[f"{what}_logit_err"], row[f"{what}_logit_rms"]
        if not math.isfinite(err) or err > LOGIT_BOUND[what] * rms:
            raise AssertionError(f"{what} logits: kernel vs plain {row}")


SERVE_KW = dict(max_len=2048, prefill_buckets=(128, 256, 512, 1024), chunk=8)
# The paged phase's pool. The requests below never press a pool of 8192
# tokens into preempting (admission reserves whole prefill buckets, which
# already cover most requests' budgets); scripts/torch_paged_pool_scan.py
# replays the schedule on the CPU, and 8000 tokens (498 usable blocks of
# 16) is the size nearest 8192 at which growth runs the pool dry: three
# preemptions, twelve lanes at once.
PAGED_KW = dict(max_batch=16, kv_pool_tokens=8000, kv_block_size=16)


def gemma_setup(seed: int = 0):
    """Full-width Gemma-2B, random bf16 weights from ``seed``, fused."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models import (
        fuse_decoder_params,
        gemma_2b,
        init_params,
    )

    cfg = gemma_2b()
    t0 = time.perf_counter()
    params = fuse_decoder_params(
        init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"],
                                       *params["layers"].values()])
    emit("serve_setup", model="gemma_2b", params=n_params,
         init_s=round(time.perf_counter() - t0, 3))
    return params, cfg


def run_requests(srv, prompts, budgets):
    """Submit every request, reset the serving kernels' launch counts, drain
    the server, read the counts. Returns the outputs in submit order, the
    wall time, the launches and the server's stats; every request must
    return its budget of in-vocabulary tokens."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward

    kernels = {"flash_fwd": flash_forward, "paged_decode": paged_decode_attention,
               "dense_decode": decode_attention}
    rids = [srv.submit(p, int(b)) for p, b in zip(prompts, budgets)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    outs = [results[rid] for rid in rids]
    for rid, out, b in zip(rids, outs, budgets):
        if len(out) != int(b):
            raise AssertionError(f"request {rid}: {len(out)} tokens, budget {b}")
        if not ((out >= 0) & (out < srv.cfg.vocab_size)).all():
            raise AssertionError(f"request {rid}: token out of vocabulary")
    if set(launches) != {"flash_fwd", "paged_decode"}:
        raise AssertionError(f"serving must launch the flash and the paged "
                             f"kernel and no other: {launches}")
    return outs, wall, launches, srv.stats()


def serve_row(stats, wall, budgets, lens, launches) -> dict:
    import torch

    generated = int(sum(budgets))
    return dict(
        requests=len(budgets), prompt_tokens=int(sum(lens)),
        generated_tokens=generated, wall_s=round(wall, 4),
        tok_s=round(generated / wall, 2),
        ttft_p50_s=stats["ttft_s"]["p50"], ttft_p99_s=stats["ttft_s"]["p99"],
        itl_p50_s=stats["decode_token_s"]["p50"],
        itl_p99_s=stats["decode_token_s"]["p99"],
        rounds=stats["rounds"], prefills=stats["prefills"],
        prefill_batches=stats["prefill_batches"],
        arena_bytes=stats["arena_bytes"],
        peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=launches)


def phase_serve(params, cfg, seed: int = 0, profile: bool = False) -> dict:
    import numpy as np

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    kw = dict(max_batch=8, **SERVE_KW)
    rng = np.random.default_rng(seed)

    # Warm-up on a throwaway server: first cuBLAS and allocator calls.
    warm = GenerationServer(params, cfg, **kw)
    warm.submit(rng.integers(0, cfg.vocab_size, 100), 8)
    warm.run()
    del warm

    lens = rng.integers(64, 1001, 16)
    budgets = rng.integers(64, 129, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    srv = GenerationServer(params, cfg, **kw)
    _, wall, launches, stats = run_requests(srv, prompts, budgets)
    if stats["decode_backend"] != attention.BACKEND_PAGED or stats["kv_quant"] != "int8":
        raise AssertionError(f"unexpected server mode: {stats}")
    emit("serve", **serve_row(stats, wall, budgets, lens, launches))
    del srv

    rows = [crosscheck(params, cfg, prompts[i], kw["prefill_buckets"], kw["max_len"])
            for i in (0, 1)]
    for row in rows:
        assert_crosscheck(row, cfg.n_layers)
    if profile:
        profile_rounds(params, cfg, kw, rng)
    return launches


def paged_crosscheck(params, cfg, prompts, budgets) -> dict:
    """One decode round of a loaded paged server with every layer's kernel
    call held against the plain version on its own inputs: the pool, the
    lanes' real (scattered, SCRATCH-filled, remapped) tables and positions
    exactly as the scheduler hands them over, dead lanes included."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import paged_decode_reference

    srv = GenerationServer(params, cfg, **PAGED_KW, **SERVE_KW)
    for p, b in zip(prompts, budgets):
        srv.submit(p, int(b))
    kernel_fn, cases = srv._decode_kernel, []
    kw = dict(block_size=PAGED_KW["kv_block_size"], paged_len=SERVE_KW["max_len"])

    def checked(q, ck, cv, tables, pos, q_lens=None):
        out = kernel_fn(q, ck, cv, tables, pos, q_lens)
        ref = paged_decode_reference(q, ck, cv, tables, pos, q_lens, **kw)
        mag = paged_decode_reference(q.float(), ck, v_abs(cv), tables, pos,
                                     q_lens, **kw)
        cases.append(check("paged layer", out, ref, mag))
        return out

    srv._decode_kernel = checked
    srv.step()  # admission of the first lanes, then one round of 8 steps
    torch.cuda.synchronize()
    want = cfg.n_layers * SERVE_KW["chunk"]
    stats = srv.stats()
    row = {"kernel_calls_checked": len(cases), "lanes": stats["lanes_busy_peak"],
           "kv_blocks_in_use": stats["kv_blocks_in_use"],
           "max_err_over_bound": max(c["max_err_over_bound"] for c in cases),
           "max_abs_err": max(c["max_abs_err"] for c in cases)}
    emit("paged_crosscheck", **row)
    if len(cases) != want or row["lanes"] < 2:
        raise AssertionError(f"paged crosscheck: {row}, want {want} checks")
    return row


def token_match(outs, other, budgets) -> dict:
    same = sum(int((a == b).sum()) for a, b in zip(outs, other))
    return {"tokens": same / int(sum(budgets)),
            "requests_identical": sum(bool((a == b).all())
                                      for a, b in zip(outs, other))}


def phase_paged(params, cfg, seed: int = 0, profile: bool = False) -> dict:
    """32 requests over the paged pool, then over the slotted arena for the
    token-match fraction (printed, not asserted: the two servers batch
    differently, cuBLAS may pick another kernel per batch size, the tiles
    differ, and random weights turn one differing rounding into another
    continuation). A third run puts the fraction in proportion: a paged
    server with the slotted server's lane count and KV tile (8 lanes, tile
    128, a pool that never presses) does the slotted server's arithmetic
    through scattered tables."""
    import numpy as np

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1001, 32)
    budgets = rng.integers(64, 129, 32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    srv = GenerationServer(params, cfg, **PAGED_KW, **SERVE_KW)
    outs, wall, launches, stats = run_requests(srv, prompts, budgets)
    row = serve_row(stats, wall, budgets, lens, launches)
    row.update({k: stats[k] for k in (
        "preemptions", "preempted_waiting", "kv_blocks_in_use", "kv_blocks_total",
        "kv_pool_tokens", "kv_pool_occupancy_peak", "lanes_busy_peak")})
    del srv
    slotted = GenerationServer(params, cfg, max_batch=8, **SERVE_KW)
    outs_s, wall_s, launches_s, stats_s = run_requests(slotted, prompts, budgets)
    slotted_row = serve_row(stats_s, wall_s, budgets, lens, launches_s)
    del slotted
    twin_kw = dict(max_batch=8, kv_pool_tokens=8 * 2048 + 2 * 128,
                   kv_block_size=128)
    twin = GenerationServer(params, cfg, **twin_kw, **SERVE_KW)
    outs_t, wall_t, _, stats_t = run_requests(twin, prompts, budgets)
    del twin
    emit("paged", config=PAGED_KW, **row,
         token_match_vs_slotted=token_match(outs, outs_s, budgets),
         slotted_same_requests={k: slotted_row[k] for k in (
             "tok_s", "wall_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
             "itl_p99_s", "rounds", "arena_bytes", "launches")},
         same_tile_and_lanes=dict(
             config=twin_kw, tok_s=round(int(sum(budgets)) / wall_t, 2),
             rounds=stats_t["rounds"], preemptions=stats_t["preemptions"],
             token_match_vs_slotted=token_match(outs_t, outs_s, budgets)))
    if (stats["decode_backend"] != attention.BACKEND_PAGED
            or stats["kv_quant"] != "int8"):
        raise AssertionError(f"unexpected server mode: {stats}")
    if stats["preemptions"] < 1:
        raise AssertionError("the pool never came under pressure: no preemption")
    if stats["kv_blocks_in_use"] or stats["preempted_waiting"]:
        raise AssertionError(f"the pool did not drain: {stats}")
    if stats["lanes_busy_peak"] <= 8:
        raise AssertionError(f"peak lanes {stats['lanes_busy_peak']}: no more "
                             "than the slotted grid")
    if launches["paged_decode"] != stats["rounds"] * SERVE_KW["chunk"] * cfg.n_layers:
        raise AssertionError(f"a decode step left the paged kernel: {launches}, "
                             f"{stats['rounds']} rounds")
    paged_crosscheck(params, cfg, prompts[:12], budgets[:12])
    if profile:
        profile_rounds(params, cfg, dict(**PAGED_KW, **SERVE_KW), rng, lanes=16)
    return launches


def phase_generate(params, cfg, seed: int = 0) -> dict:
    """``generate()`` under ``KATA_TPU_DECODE_KERNEL=1``: lock-step decode
    through the dense kernel, counted; then each layer's kernel call of the
    first decode step held against the plain version on the model's own q,
    k and v; then the run without the opt-in (the paged kernel over the
    slotted re-view) for the token-match fraction."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.constants import ENV_DECODE_KERNEL
    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        CUDA_PAD,
        _decode_scan,
        generate,
        prefill,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import attention
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward

    B, S, steps = 8, 128, 64
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    kernels = {"flash_fwd": flash_forward, "paged_decode": paged_decode_attention,
               "dense_decode": decode_attention}

    def run():
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        toks = generate(params, prompt, cfg, steps)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0, {
            k: fn.launches for k, fn in kernels.items()}

    os.environ.pop(ENV_DECODE_KERNEL, None)
    plain_toks, plain_wall, plain_launches = run()
    os.environ[ENV_DECODE_KERNEL] = "1"
    try:
        toks, wall, launches = run()
        # The per-layer check: the first decode step again, by hand, with
        # the default dispatch wrapped.
        cases = []

        def checked(q, k, v, causal=True, q_offset=None, **kw):
            out = attention.flash_attention(q, k, v, causal=causal,
                                            q_offset=q_offset, **kw)
            if q_offset is not None:
                ref = attention.reference_attention(q, k, v, q_offset=q_offset)
                mag = attention.reference_attention(
                    q.float(), k.float(), v.abs().float(), q_offset=q_offset)
                cases.append(check("generate layer", out, ref, mag))
            return out

        caches, last, pos = prefill(  # the cache length generate() pads to
            params, torch.as_tensor(prompt, device="cuda"), cfg,
            -(-(S + steps) // CUDA_PAD) * CUDA_PAD)
        before = decode_attention.launches
        _decode_scan(params, caches, last, pos, cfg, 1, attn_fn=checked)
        checked_launches = decode_attention.launches - before
    finally:
        del os.environ[ENV_DECODE_KERNEL]
    want = {"flash_fwd": cfg.n_layers, "paged_decode": 0,
            "dense_decode": cfg.n_layers * (steps - 1)}
    emit("generate", B=B, prompt=S, steps=steps, cache="bf16",
         wall_s=round(wall, 4), tok_s=round(B * steps / wall, 2),
         launches=launches, wall_without_opt_in_s=round(plain_wall, 4),
         launches_without_opt_in=plain_launches,
         token_match_vs_without_opt_in=float((toks == plain_toks).float().mean()),
         layers_checked=len(cases),
         layer_max_err_over_bound=max(c["max_err_over_bound"] for c in cases))
    if launches != want:
        raise AssertionError(f"generate launches {launches}, want {want}")
    if plain_launches["dense_decode"] or not plain_launches["paged_decode"]:
        raise AssertionError(f"without the opt-in: {plain_launches}")
    if len(cases) != cfg.n_layers or checked_launches != cfg.n_layers:
        raise AssertionError(f"generate crosscheck: {len(cases)} checks, "
                             f"{checked_launches} launches")
    if toks.shape != (B, steps) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("generate: bad tokens")
    return {k: v for k, v in launches.items() if v}


def train_flops_per_step(cfg, B: int, S: int) -> float:
    """Model FLOPs of one train step, the JAX package's bench convention
    (``bench.py`` ``measure_train``): 6 x matmul parameters x tokens
    (embedding gather excluded, untied unembedding included) plus causal
    attention 6 L B S^2 H Dh."""
    per_layer = (cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
                 + cfg.q_dim * cfg.d_model + 3 * cfg.d_model * cfg.d_ff)
    matmul_params = cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size
    attn = 6 * cfg.n_layers * B * S * S * cfg.n_heads * cfg.head_dim
    return 6.0 * matmul_params * B * S + attn


def phase_train(seed: int = 0, n_layers: int = 8, steps: int = 6,
                profile: bool = False) -> dict:
    """``fit`` at Llama-3-8B widths with ``n_layers`` of 32 layers on one
    batch of B=2 windows of 2048 tokens, seen every step. ``profile`` adds
    one more step under the profiler."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models import llama3_8b
    from kata_xpu_device_plugin_tpu_torch.ops import flash
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        TokenBatchLoader,
        fit,
        make_optimizer,
        make_train_step,
    )
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves

    cfg = llama3_8b(n_layers=n_layers)
    B, seq_len = 2, 2047
    stream = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, B * (seq_len + 1)).astype(np.int32)
    loader = TokenBatchLoader(stream, batch=B, seq_len=seq_len, shuffle=False)
    init_state, step = make_train_step(cfg, make_optimizer(), remat=False)
    stamps = []

    def on_step(_s, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = (flash.flash_forward, flash.flash_bwd_dq, flash.flash_bwd_dkv)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    state, losses = fit(init_state, step, loader, steps=steps, seed=seed,
                        on_step=on_step)
    launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                        (fn.launches for fn in kernels)))
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in leaves(state["params"]))
    if profile:
        batch = next(loader)
        profiled(f"train step {steps + 1}, B={B}, S={seq_len + 1}",
                 lambda: step(state, batch))
    del state
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    p50 = float(np.median(step_s))
    tokens = B * (seq_len + 1)
    flops = train_flops_per_step(cfg, B, seq_len + 1)
    emit("train", model="llama3_8b", n_layers=n_layers,
         reduced="n_layers=8 (from 32; one card's memory)", params=n_params,
         B=B, S=seq_len + 1, steps=steps, losses=losses,
         first_step_s=stamps[0] - t0, step_s=step_s, step_p50_s=p50,
         tokens_per_s=tokens / p50, model_flops_per_step=flops,
         mfu=flops / p50 / PEAK_BF16_FLOPS, peak_mem_bytes=peak,
         device_mem_bytes=torch.cuda.get_device_properties(0).total_memory,
         launches=launches)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train loss not finite and falling: {losses}")
    want = steps * n_layers
    if any(n != want for n in launches.values()):
        raise AssertionError(f"train launches {launches}, want {want} each")
    return launches


def train_crosscheck(seed: int = 1, n_layers: int = 2) -> dict:
    """One ``next_token_loss`` backward at Llama-3-8B widths with
    ``n_layers`` layers, B=1, S=2048, through the kernels and through
    ``reference_attention``, from the same fp32 weights and tokens. On the
    kernel path each layer's forward (with lse) and backward kernel call is
    held against the plain version on its own inputs; the loss difference
    and the cosine of the whole gradient are printed, not bounded (random
    weights carry each layer's rounding on through the model)."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models import init_params, llama3_8b
    from kata_xpu_device_plugin_tpu_torch.models.transformer import next_token_loss
    from kata_xpu_device_plugin_tpu_torch.ops import flash
    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves

    checks = {"fwd": [], "bwd": []}

    class Checked(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = flash.flash_forward(q, k, v, return_lse=True)
            ref, ref_lse = flash.flash_reference(q, k, v)
            mag = reference_attention(q.float(), k.float(), v.abs().float())
            checks["fwd"].append({**check("train layer fwd", out, ref, mag),
                                  "lse_max_abs_err": check_lse("layer", lse, ref_lse)})
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            got = flash.flash_backward(q, k, v, out, lse, do)
            want = flash.flash_backward_reference(q, k, v, out, lse, do)
            mags = flash.backward_magnitudes(q, k, v, out, lse, do)
            checks["bwd"].append(check_grads("train layer bwd", got, want, mags))
            return got

    def checked_attn(q, k, v, causal=True, q_offset=None, **kw):
        assert causal and q_offset is None and not kw
        return Checked.apply(q, k, v)

    cfg = llama3_8b(n_layers=n_layers)
    params = init_params(cfg, seed=seed, device="cuda", dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, 2048))).cuda()
    xs = [p.requires_grad_() for p in leaves(params)]
    results = {}
    for name, fn in (("kernel", checked_attn), ("plain", reference_attention)):
        loss = next_token_loss(params, toks, cfg, attn_fn=fn)
        results[name] = (float(loss.detach()), torch.autograd.grad(loss, xs))
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    dot = sum(float((a.double() * b.double()).sum()) for a, b in zip(gk, gp))
    nk = math.sqrt(sum(float(a.double().square().sum()) for a in gk))
    np_ = math.sqrt(sum(float(b.double().square().sum()) for b in gp))
    row = {"n_layers": n_layers, "B": 1, "S": 2048, "loss_kernel": lk,
           "loss_plain": lp, "loss_diff": lk - lp, "grad_cosine": dot / (nk * np_),
           "layers_checked_fwd": len(checks["fwd"]),
           "layers_checked_bwd": len(checks["bwd"]),
           "fwd_max_err_over_bound": max(c["max_err_over_bound"] for c in checks["fwd"]),
           "lse_max_abs_err": max(c["lse_max_abs_err"] for c in checks["fwd"]),
           "bwd_max_err_over_bound": max(c[g]["max_err_over_bound"]
                                         for c in checks["bwd"] for g in c)}
    emit("train_crosscheck", **row)
    if row["layers_checked_fwd"] != n_layers or row["layers_checked_bwd"] != n_layers:
        raise AssertionError(f"train crosscheck checked {row}")
    if not (math.isfinite(lk) and math.isfinite(row["grad_cosine"])):
        raise AssertionError(f"train crosscheck not finite: {row}")
    return row


def main(argv: list[str]) -> int:
    if not os.path.isdir(os.path.join(HERE, PKG, "csrc")):
        print(f"chip_smoke: {PKG} not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile = "--profile" in argv  # adds profiled decode rounds and a train step
    seconds = {}

    def timed_phase(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 2)
        return out

    phase_device()
    timed_phase("build", phase_build)
    checks = timed_phase("check", phase_checks)
    extra = checks.pop("paged_decode_extra")
    params, cfg = timed_phase("serve_setup", gemma_setup)
    launches = {"serve": timed_phase("serve", phase_serve, params, cfg,
                                     profile=profile)}
    launches["paged"] = timed_phase("paged", phase_paged, params, cfg,
                                    profile=profile)
    launches["generate"] = timed_phase("generate", phase_generate, params, cfg)
    del params
    torch.cuda.empty_cache()
    launches["train"] = timed_phase("train", phase_train, profile=profile)
    timed_phase("train_crosscheck", train_crosscheck)
    emit("seconds", **seconds, total=round(sum(seconds.values()), 2))
    src = f"{PKG}/csrc"
    jax_flash = "kata_xpu_device_plugin_tpu/ops/flash.py"
    meta = {
        "flash_fwd": dict(route="cuda", source=f"{src}/flash_fwd.cu",
                          replaces=f"{jax_flash}:70"),
        "paged_decode": dict(route="cuda", source=f"{src}/paged_decode.cu",
                             replaces="kata_xpu_device_plugin_tpu/ops/decode_attn.py:213",
                             extra=extra),
        "dense_decode": dict(route="cuda", source=f"{src}/dense_decode.cu",
                             replaces="kata_xpu_device_plugin_tpu/ops/decode_attn.py:74"),
        "flash_bwd_dq": dict(route="cuda", source=f"{src}/flash_bwd.cu",
                             replaces=f"{jax_flash}:219"),
        "flash_bwd_dkv": dict(route="cuda", source=f"{src}/flash_bwd.cu",
                              replaces=f"{jax_flash}:283"),
    }
    kernels = []
    for name, cases in checks.items():
        timed = next(c for c in cases if "ms" in c)
        by_path = {p: n[name] for p, n in launches.items() if name in n}
        kernels.append({
            "name": name, **meta[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_err_over_bound": max(c["max_err_over_bound"] for c in cases),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"], "timed_case": timed["case"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
