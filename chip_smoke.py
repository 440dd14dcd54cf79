#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card (``nvidia-smi`` name and power limit) and CUDA version;
2. build  — compile every kernel under ``kata_xpu_device_plugin_tpu_torch/csrc``;
3. check  — each kernel against its plain PyTorch version on the card,
   bf16, at the main paths' shapes and layouts, within the per-element and
   mean bounds of ``ops.attention.kernel_tolerance`` (for the backward
   kernels with the magnitudes ``ops.flash.backward_magnitudes`` derives);
   the forward's logsumexp in fp32. The flash forward at the serving
   prefill shapes, and where its tiles meet the masks and the sequence's
   end (full attention, D=64, window 96 with softcap 30, S=160 and 320, B=1
   S=128, GQA 4) with and without the lse, a second launch of each giving
   the same bits; timed by CUDA-graph replay beside SDPA's forward at the
   Gemma-2B prefill shape (the kernels line) and, with the lse, at the two
   training shapes (the ``flash_fwd_train`` line). The paged decode kernel
   walks permuted, non-contiguous tables with unmapped entries, ragged
   positions and a dead lane, at Gemma-2B and Llama-3-8B head shapes,
   single-query and as spans of 4 and 8 rows with ragged query lengths
   (real rows within the bound and bit-equal to a single-query launch at
   the row's position, padding rows finite and within max|V|), also at tile
   1024, whose chunks the split pass walks in pieces; the dense decode
   kernel at five shared positions; a second launch of each decode kernel
   on the same inputs must give the same bits; each decode kernel is also
   timed at a working set past the 50 MB L2 (paged int8, 64 lanes at
   position 4095, tile 16; dense bf16, 32 rows at position 4095), against
   its byte bound; both decode kernels at Qwen2-7B's heads (28 over 4, a
   GQA group of 7; paged int8 and bf16, tiles 16 and 128, a dead lane,
   single-query and spans of 4; dense at positions 5 and 2047), timed; the
   flash forward at the families' windowed prefill shapes (Gemma-2-2B:
   S=6144, window 4096, softcap 50; Gemma-3-4B: S=2048, window 1024),
   timed; the flash backward kernels at head_dim 64, 128 and 256
   (the Llama-3-8B and Gemma-2B train shapes timed, beside the ``delta``
   reduction and the SDPA backward), both with ``delta`` given and with the
   dq kernel forming it (``flash_backward``), and a second launch of each
   giving the same bits;
4. serve  — full-width Gemma-2B (random bf16 weights, fused) served by
   the default ``GenerationServer`` (overlapped rounds, int8 KV, chunk 8,
   each decode chunk after the first one CUDA graph replay): 16 requests;
   launch counts of both kernels reset just before and read just after,
   and for every server run: the paged kernel's launches equal rounds x
   chunk x decode_steps x layers, counted through the replays, one
   capture, and every round after the warm-up chunk a replay. Beside it
   the lock-step server (``overlap=False``) on the same requests: tok/s,
   TTFT, ITL, rounds and the token-match fraction (printed; the two loops
   may group admissions differently, and bf16 GEMMs at another batch round
   differently). Then ``graph_check``: one chunk by capture and replay
   against the same chunk run eagerly on a clone of the arena, tokens,
   ``last``, ``pos`` and every arena byte bit-equal, with the capture's
   seconds and its graph pool's bytes. Then two requests through the
   kernel path and the plain path: every layer's kernel call held against
   the plain version on its own inputs, and the logits held against the
   plain path's (``crosscheck``);
5. paged  — the same model served over a paged block pool:
   ``GenerationServer(max_batch=16, kv_pool_tokens=8000, kv_block_size=16)``,
   32 requests, overlapped; every decode step walks the lanes' real block
   tables with the paged kernel; the pool comes under pressure, so lanes
   are preempted, spilled and resumed. Asserted: every budget returned, at
   least one preemption, an empty pool at the end, more than 8 lanes at
   once. Beside it the lock-step paged server and the paged server at
   ``decode_steps=4`` on the same requests, and ``graph_check`` over the
   pool. Then one round of a loaded paged server with every layer's kernel
   call held against the plain version on its own inputs
   (``paged_crosscheck``), and the slotted server on the same requests for
   the token-match fraction;
6. persistent — the serve phase's 16 requests (slotted) and the paged
   phase's 32 (paged) through ``persistent=True`` servers (a round decodes
   until its cap of 256 steps, a lane's eos or budget, or a lane's window
   edge; one graph replay a step, the exit flag read from pinned memory),
   each beside the lock-step server on the same requests. Asserted: equal
   tokens; the exits partition the rounds; the tokens the rounds delivered
   are the tokens emitted past each first; paged kernel launches = steps
   executed x layers, counted through replays; fewer than ``sub_steps``
   steps a round past its exit. Printed: tok/s, ITL, rounds, steps
   delivered a round, exits, preemptions, steps past exits. Then
   ``persistent_graph_check`` for both arenas: a round by replay against
   the same round eager on a clone of the arena, every byte, with the
   paged eager round's kernel calls held against the plain version;
7. sched — the serve phase's config and requests through ``fifo_batch``
   and ``slo_chunked`` (``itl_slo_ms=0``, ``prefill_chunk=128``) fused and
   unfused, at the default deadline, and fused over a bf16 cache: tok/s,
   TTFT, ITL, chunks, fused admissions, the token match against fifo and
   the plain top-2 margin where they first part. Asserted: chunks ran and
   fused ones rode decode dispatches; each chunked admission's first-token
   logits within the serving bound of one read-back slice of the whole
   prompt, and over the bf16 cache of the whole plain prefill; a whole
   admission pass's flash calls within ``kernel_tolerance``;
8. generate — ``generate()`` at full width, B=8, prompt 128, 64 steps, bf16
   cache, under ``KATA_TPU_DECODE_KERNEL=1``: 18 x 63 launches of the dense
   decode kernel, each layer of the first decode step held against the
   plain version, and the token-match fraction against the run without
   the opt-in (which launches the dense kernel no time);
9. families — Gemma-2-2B (26 layers, max_len 8192, four prompts of
   4200-6000 tokens), Qwen2-7B (28 layers), Gemma-3-4B (6 of 34 layers,
   its cycles cut with it) and Mistral-7B (4 of 32 layers, max_len 8192,
   four long prompts) at their published widths, random bf16 weights, each
   through the default server over a paged pool (16 lanes, tile 16): 16
   greedy requests (Qwen2 decodes through the paged kernel at its group of
   7, counted; the windowed families with the plain attention by the JAX
   rule, reason printed), the same requests sampled (temperature 0.7,
   top-k 50, top-p 0.9, seed 0) by two servers that must give equal tokens,
   ``graph_check`` on a sampled chunk, and a prefill crosscheck (each
   layer's flash call against the plain version; logits within the serving
   bound or twice the run's noise floor); then ``generate()`` at Qwen2-7B
   widths with 4 layers under ``KATA_TPU_DECODE_KERNEL=1``
   (``generate_qwen2``, dense kernel at group 7);
10. train — Llama-3-8B at its published widths with 8 of its 32 layers
   (one card's memory), random fp32 parameters from seed 0, bf16 compute:
   ``make_train_step`` and ``fit`` for 6 AdamW steps on one repeated
   batch (B=2, S=2048); launch counts reset just before and read just
   after (8 forward, 8 dq and 8 dk/dv launches a step); the loss must be
   finite and fall. Then ``train_crosscheck``: one ``next_token_loss``
   backward at 2 layers, B=1, through the kernels (each layer's forward
   and backward kernel call held against the plain version on its own
   inputs) and through ``reference_attention``; the loss difference and
   the cosine of the whole gradient are printed;
11. train_gemma — the same at Gemma-2B's published widths (head_dim 256,
   MQA, GeGLU, tied and scaled embeddings) with 6 of its 18 layers: 4 steps
   (6 launches of each kernel a step), then its 2-layer crosscheck.

Then the ``{"kernels": [...]}`` line and, last, the device line.
``--profile`` adds ``torch.profiler`` windows over decode rounds of a loaded
server (slotted and paged, overlapped and lock-step; at least 48 steps,
all graph replays), each printing the card's idle share, and one over a step
of each train phase (and, in the families phase, a window of each
family's decode rounds). Any failed
phase raises: the script exits non-zero and prints no result. Without CUDA,
or outside a checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import replace

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
# The families run deeper (up to 28 layers), and random weights carry a
# rounding difference on through every layer: there, two equally valid bf16
# attentions (``plain_fp32_p`` against the plain version) already differ by
# 1-3x the logit RMS. A family's kernel path is held to the serving bound
# above or, past it, to this multiple of that noise floor measured in the
# same run on the same request (readings on an H100, PR 8: kernel against
# plain 0.85-1.10 x the noise floor for Gemma-2B and the four families).
NOISE_FACTOR = 2.0


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


def graph_ms(fn, iters: int) -> float:
    """Device time of ``fn`` per call: ``iters`` calls captured in one CUDA
    graph, replayed between two CUDA events. A decode call takes less
    device time than its Python wrapper takes on the host, so back-to-back
    eager calls (``time_ms``) would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def spilling_functions(log: str) -> dict:
    """ptxas -v output to ``{function: bytes of spill stores}``, for the
    functions that spill."""
    spills, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[-1].strip()
        elif "spill stores" in ln and fn is not None:
            n = int(ln.split("bytes spill stores")[0].split(",")[-1])
            if n:
                spills[fn] = n
    return spills


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
         sources=_build.sources(), ptxas=regs,
         spills={n: spilling_functions(log) for n, log in _build.build_log.items()})


def live_pairs(S: int, causal: bool = True, window: int = 0) -> float:
    """(q row, key) pairs one head attends: all, the causal triangle, or
    the causal band of ``window`` keys."""
    if not causal:
        return float(S * S)
    if window and window < S:
        return window * (window + 1) / 2 + (S - window) * window
    return S * (S + 1) / 2


def flash_fwd_bound(B, S, H, KV, D, causal=True, lse=False, window=0) -> dict:
    """The least time the card could take for the forward: two D-long
    products a live (q row, key) pair over the bf16 peak, or q, k and v
    read once and the output (and the lse) written once over the memory
    rate, the larger."""
    pairs = B * H * live_pairs(S, causal, window)
    t_ops = 4.0 * D * pairs / PEAK_BF16_FLOPS
    nbytes = 2.0 * B * S * D * (2 * H + 2 * KV) + (4.0 * B * H * S if lse else 0.0)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def flash_case(name, B, S, H, KV, D, causal=True, window=0, softcap=0.0,
               lse=False, timed=False):
    """q/k/v are slices of one fused ``[B, S, (H + 2 KV) D]`` projection,
    the strided layout the transformer's fused ``wqkv`` hands the kernel.
    The kernel without the lse is held against the plain version; with
    ``lse`` the instantiation that writes it too, its lse within LSE_TOL. A
    second launch of each must give the same bits. ``timed``: the kernel
    (with the lse when ``lse``) and SDPA by CUDA-graph replay, the eager
    call beside them."""
    import torch
    import torch.nn.functional as F

    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward, flash_reference

    g = torch.Generator(device="cuda").manual_seed(B * S + H + D)
    qkv = torch.randn(B, S, (H + 2 * KV) * D, generator=g, device="cuda",
                      dtype=torch.bfloat16)
    q = qkv[..., : H * D].reshape(B, S, H, D)
    k = qkv[..., H * D: (H + KV) * D].reshape(B, S, KV, D)
    v = qkv[..., (H + KV) * D:].reshape(B, S, KV, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    rkw = dict(causal=causal, window=window, logits_softcap=softcap)
    out = flash_forward(q, k, v, **kw)
    ref = reference_attention(q, k, v, **rkw)
    mag = reference_attention(q.float(), k.float(), v.abs().float(), **rkw)
    torch.cuda.synchronize()
    res = check(name, out, ref, mag)
    relaunch_equal(name, out, flash_forward(q, k, v, **kw))
    if lse:
        out_l, lse_k = flash_forward(q, k, v, return_lse=True, **kw)
        _, ref_lse = flash_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        res_l = check(f"{name} (lse)", out_l, ref, mag)
        for f in ("max_abs_err", "max_err_over_bound"):
            res[f] = max(res[f], res_l[f])
        res["lse_max_abs_err"] = check_lse(name, lse_k, ref_lse)
        again = flash_forward(q, k, v, return_lse=True, **kw)
        relaunch_equal(f"{name} (lse)", out_l, again[0])
        relaunch_equal(f"{name} lse", lse_k, again[1])
    del ref, mag
    if timed:
        call = lambda: flash_forward(q, k, v, return_lse=lse, **kw)  # noqa: E731
        res["ms"] = graph_ms(call, 20)
        res["call_ms"] = time_ms(call, 20)
        if lse:
            res["plain_ms"] = time_ms(lambda: flash_reference(q, k, v, **kw), 3, 1)
        else:
            res["plain_ms"] = time_ms(lambda: reference_attention(q, k, v, **rkw),
                                      3, 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if softcap:
            res["library_ms"] = None  # no PyTorch call caps the logits
        elif window:  # SDPA with the band as a mask computes the same
            i = torch.arange(S, device="cuda")
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True), 20)
        else:
            res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        res.update(flash_fwd_bound(B, S, H, KV, D, causal, lse, window))
    emit("check", kernel="flash_fwd", B=B, S=S, H=H, KV=KV, D=D, causal=causal,
         window=window, softcap=softcap, lse=lse, relaunch_bit_equal=True, **res)
    return res


def relaunch_equal(name: str, out, again) -> None:
    """The decode kernels' split-K merge and the backward kernels' sums run
    in a fixed order with no atomics: a second launch on the same inputs
    must give the same bits."""
    import torch

    if not torch.equal(out, again):
        raise AssertionError(f"{name}: a second launch gave other bits")


def decode_bound(keys: float, B, SQ, H, KV, D, nb, quantized, flops) -> dict:
    """The least time the card could take for a paged decode call that must
    read ``keys`` K rows and as many V rows once (payload and, for int8,
    scale), q and the tables once, and write the output once."""
    row_bytes = D * (1 if quantized else 2) + (4 if quantized else 0)
    nbytes = 2 * keys * KV * row_bytes + 2 * 2 * B * SQ * H * D + 4 * B * (nb + 2)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def paged_inputs(B, H, KV, D, bs, quantized, max_len=2048, dead=False,
                 full=False):
    """A paged decode call's inputs on the card: a pool whose block 0 is the
    ZERO block, permuted tables whose entries past each lane's position are
    unmapped, random positions (every lane at the view's last if ``full``;
    the last lane dead, past its table, if ``dead``). Returns ``(q, k, v,
    tables, pos, kw)``."""
    import torch

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
    if full:  # every lane at the view's last position
        pos.fill_(max_len - 1)
    if dead:
        pos[-1] = 10_000  # a dead lane's stale position, past its table
    perm = torch.randperm(B * nb, generator=g, device="cuda").to(torch.int32) + 2
    tables = perm.reshape(B, nb).clone()
    live = torch.arange(nb, device="cuda")[None, :] <= (pos // bs)[:, None]
    tables = torch.where(live, tables, torch.zeros_like(tables))  # unmapped: ZERO
    k, v = (quantize_kv(pk), quantize_kv(pv)) if quantized else (pk, pv)
    return q, k, v, tables, pos, dict(block_size=bs, paged_len=max_len)


def decode_case(name, B, H, KV, D, bs, quantized, max_len=2048, timed=False,
                dead=False, full=False):
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        paged_decode_attention,
        paged_decode_reference,
    )

    q, k, v, tables, pos, kw = paged_inputs(B, H, KV, D, bs, quantized, max_len,
                                            dead, full)
    nb = max_len // bs
    out = paged_decode_attention(q, k, v, tables, pos, **kw)
    ref = paged_decode_reference(q, k, v, tables, pos, **kw)
    mag = paged_decode_reference(q.float(), k, v_abs(v), tables, pos, **kw)
    torch.cuda.synchronize()
    res = check(name, out, ref, mag)
    del ref, mag
    relaunch_equal(name, out, paged_decode_attention(q, k, v, tables, pos, **kw))
    if timed:
        call = lambda: paged_decode_attention(q, k, v, tables, pos, **kw)  # noqa: E731
        res["ms"] = graph_ms(call, 20)
        res["call_ms"] = time_ms(call, 20)
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
        call = lambda: paged_decode_attention(  # noqa: E731
            q, k, v, tables, pos, q_lens, **kw)
        res["ms"] = graph_ms(call, 20)
        res["call_ms"] = time_ms(call, 20)
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


def dense_inputs(B, S, H, KV, D, pos):
    """A dense decode call's inputs on the card: one query token a row, a
    dense bf16 cache ``[B, S, KV, D]``, a device-scalar position."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(S + H + D + pos)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q, k, v = rnd(B, 1, H, D), rnd(B, S, KV, D), rnd(B, S, KV, D)
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda")


def sdpa_call(q, k, v, pos: int):
    """``scaled_dot_product_attention`` over ``k[:, :pos+1]``: the library
    call that computes what the dense kernel does (timed, never used)."""
    import torch.nn.functional as F

    qt = q.transpose(1, 2)
    kt, vt = (t[:, :pos + 1].transpose(1, 2) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)


def dense_case(name, B, S, H, KV, D, pos, timed=False):
    """The lock-step dense kernel: one token per row into a dense bf16 cache
    read in place, one device-scalar position for the whole batch."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        decode_attention,
        decode_attention_reference,
    )

    q, k, v, p = dense_inputs(B, S, H, KV, D, pos)
    out = decode_attention(q, k, v, p)
    ref = decode_attention_reference(q, k, v, p)
    mag = decode_attention_reference(q.float(), k.float(), v.abs().float(), p)
    torch.cuda.synchronize()
    res = check(name, out, ref, mag)
    del ref, mag
    relaunch_equal(name, out, decode_attention(q, k, v, p))
    if timed:
        res["ms"] = graph_ms(lambda: decode_attention(q, k, v, p), 20)
        res["call_ms"] = time_ms(lambda: decode_attention(q, k, v, p), 20)
        res["plain_ms"] = time_ms(lambda: decode_attention_reference(q, k, v, p), 5, 1)
        res["library_ms"] = graph_ms(sdpa_call(q, k, v, pos), 20)
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
    q and k come out of rope, v out of its own projection): each wrapper
    with the ``delta`` reduction given, and ``flash_backward``, whose dq
    kernel forms delta itself; a second launch of each must give the same
    bits (each element summed in a fixed order, no atomics)."""
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
    fused = flash.flash_backward(q, k, v, out, lse, do, **kw)
    want = flash.flash_backward_reference(q, k, v, out, lse, do, **kw)
    mags = flash.backward_magnitudes(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    res = check_grads(name, got, want, mags)
    res_fused = check_grads(f"{name} (delta in dq)", fused, want, mags)
    del want, mags
    for gname, a, b in zip(("dq", "dk", "dv"), fused,
                           flash.flash_backward(q, k, v, out, lse, do, **kw)):
        relaunch_equal(f"{name} {gname}", a, b)
    del fused
    row = {"dq": {"case": name, **res["dq"]},
           "dkv": {"case": name,
                   **{f: max(res["dk"][f], res["dv"][f]) for f in
                      ("max_abs_err", "mean_abs_err", "max_err_over_bound")},
                   "mean_bound": min(res["dk"]["mean_bound"],
                                     res["dv"]["mean_bound"])}}
    for key, grads in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
        row[key]["max_err_over_bound"] = max(
            row[key]["max_err_over_bound"],
            *(res_fused[g_]["max_err_over_bound"] for g_ in grads))
    if timed:
        ms_dq = time_ms(lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw), 10)
        ms_dkv = time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw), 10)
        ms_delta = time_ms(lambda: flash._delta(out, do), 10)
        ms_backward = time_ms(lambda: flash.flash_backward(
            q, k, v, out, lse, do, **kw), 10)
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
        # Like for like with the SDPA backward: the two kernels plus the
        # delta reduction they are given, and flash_backward (delta formed
        # in the dq kernel).
        row["dq"].update(delta_ms=ms_delta, pair_with_delta_ms=ms_dq + ms_dkv + ms_delta,
                         flash_backward_ms=ms_backward)
    timing = {f"{k_}_{f}": row[k_][f] for k_ in ("dq", "dkv") for f in
              ("ms", "plain_ms", "library_ms", "bound_ms", "delta_ms",
               "pair_with_delta_ms", "flash_backward_ms") if f in row[k_]}
    emit("check", kernel="flash_bwd", B=B, S=S, H=H, KV=KV, D=D, causal=causal,
         window=window, softcap=softcap, lse_max_abs_err=lse_err,
         **{k_: {f: v_ for f, v_ in r.items() if f != "case"}
            for k_, r in res.items()},
         delta_in_dq={k_: r["max_err_over_bound"] for k_, r in res_fused.items()},
         relaunch_bit_equal=True, **timing)
    return row


def bandwidth_fields(prefix: str, res: dict) -> dict:
    """Move a timed case's times out of its check result (the kernels
    line's timed case stays the main path's shape), with its share of the
    bound."""
    out = {f"{prefix}_{f}": res.pop(f) for f in (
        "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    out[f"{prefix}_share_of_bound"] = out[f"{prefix}_bound_ms"] / out[f"{prefix}_ms"]
    return out


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
    # Where the forward's tiles meet the masks and the sequence's end, each
    # also through the instantiation that writes the lse.
    for args, kw in (
            (("non-causal", 2, 256, 8, 2, 128), dict(causal=False)),
            (("D64", 2, 256, 8, 2, 64), {}),
            (("D256 window96+softcap30", 1, 320, 4, 1, 256),
             dict(window=96, softcap=30.0)),
            (("S160 part tile", 2, 160, 8, 2, 128), {}),
            (("S320 part tile MQA", 1, 320, 8, 1, 256), {}),
            (("B1 S128 lse", 1, 128, 8, 1, 256), {}),
            (("GQA4", 2, 256, 16, 4, 128), {})):
        f.append(flash_case(*args, lse=True, **kw))
    # The training shapes, timed with the lse; the kernels line's timed case
    # stays the prefill shape, these go beside it.
    train = {}
    for model, shape in (("llama3_8b", (2, 2048, 32, 8, 128)),
                         ("gemma2b", (2, 2048, 8, 1, 256))):
        c = flash_case(f"{model} train B2 S2048", *shape, lse=True, timed=True)
        train.update({f"{model}_{k_}": c.pop(k_) for k_ in (
            "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        f.append(c)
    emit("flash_fwd_train", shape="B=2 S=2048, causal, with the lse: llama3_8b "
         "H=32 KV=8 D=128, gemma2b H=8 KV=1 D=256", **train)
    # The families' prefill shapes: Gemma-2-2B's local layers (window 4096,
    # softcap 50) at S = 6144, where the window's lower edge skips tiles,
    # and Gemma-3-4B's (window 1024) at S = 2048; timed beside the plain
    # version and, without the cap, SDPA over the band.
    for prefix, args, kw in (
            ("gemma2_2b", ("gemma2-2b B1 S6144 window4096 softcap50", 1, 6144,
                           8, 4, 256), dict(window=4096, softcap=50.0)),
            ("gemma3_4b", ("gemma3-4b B1 S2048 window1024", 1, 2048, 8, 4, 256),
             dict(window=1024))):
        c = flash_case(*args, timed=True, **kw)
        train.update(bandwidth_fields(prefix, c))
        f.append(c)
    results["flash_fwd_extra"] = train
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
                    for f in ("call_ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by"):
                        tiles[f"bs{bs}_{f}"] = c.pop(f)
                d.append(c)
                for SQ in (4, 8):
                    c = decode_mq_case(f"{model} {kind} bs{bs} SQ{SQ}", 8, H, KV,
                                       D, bs, quantized, SQ,
                                       timed=timed and SQ == 8 and bs == 16)
                    if "ms" in c:
                        tiles.update({f"sq8_bs16_{f}": c.pop(f) for f in (
                            "ms", "call_ms", "plain_ms", "library_ms",
                            "bound_ms", "bound_by")})
                    d.append(c)
    # Tiles of more keys than the split pass holds logits for at once: the
    # chunk is walked in pieces.
    for quantized in (True, False):
        kind = "int8" if quantized else "bf16"
        d.append(decode_mq_case(f"gemma2b {kind} bs1024 SQ4", 8, 8, 1, 256,
                                1024, quantized, 4, max_len=4096))
    # The bandwidth case: a working set past the L2 (~136 MB of int8 KV).
    c = decode_case("gemma2b int8 bs16 B64 pos4095", 64, 8, 1, 256, 16, True,
                    max_len=4096, timed=True, full=True)
    tiles.update(bandwidth_fields("bw_b64_pos4095", c))
    d.append(c)
    # Qwen2-7B's heads: 28 query heads over 4 KV heads, a group of 7.
    for bs in (16, 128):
        for quantized in (True, False):
            kind = "int8" if quantized else "bf16"
            timed = quantized and bs == 16
            c = decode_case(f"qwen2-7b {kind} bs{bs} dead lane", 8, 28, 4, 128,
                            bs, quantized, dead=True, timed=timed)
            if timed:
                tiles.update(bandwidth_fields("qwen2_g7_bs16", c))
            d.append(c)
            d.append(decode_mq_case(f"qwen2-7b {kind} bs{bs} SQ4", 8, 28, 4,
                                    128, bs, quantized, 4))
    emit("paged_decode_tiles", shape="B=8 H=8 KV=1 D=256 int8, max_len 2048, "
         "ragged pos, one dead lane; bw_: B=64, max_len 4096, every lane at "
         "4095, tile 16; qwen2_g7_: B=8 H=28 KV=4 D=128 int8, tile 16",
         **tiles)
    results["paged_decode_extra"] = tiles
    n = results["dense_decode"]
    for pos in (0, 127, 128, 1000, 2047):
        n.append(dense_case(f"gemma2b B8 S2048 pos{pos}", 8, 2048, 8, 1, 256, pos,
                            timed=pos == 2047))
    for pos in (5, 2047):
        n.append(dense_case(f"llama3-8b B8 S2048 pos{pos}", 8, 2048, 32, 8, 128,
                            pos))
    c = dense_case("gemma2b B32 S4096 pos4095", 32, 4096, 8, 1, 256, 4095,
                   timed=True)
    dense = bandwidth_fields("bw_b32_pos4095", c)
    n.append(c)
    n.append(dense_case("qwen2-7b B8 S2048 pos5", 8, 2048, 28, 4, 128, 5))
    c = dense_case("qwen2-7b B8 S2048 pos2047", 8, 2048, 28, 4, 128, 2047,
                   timed=True)
    dense.update(bandwidth_fields("qwen2_g7", c))
    n.append(c)
    emit("dense_decode_bandwidth", shape="B=32 S=4096 H=8 KV=1 D=256 bf16, "
         "pos 4095; qwen2_g7_: B=8 S=2048 H=28 KV=4 D=128, pos 2047", **dense)
    results["dense_decode_extra"] = dense
    bwd = [  # llama3-8b widths unless the case says otherwise
        bwd_case("llama3-8b train B2 S2048", 2, 2048, 32, 8, 128, timed=True),
        bwd_case("llama3-8b B1 S128", 1, 128, 32, 8, 128),
        bwd_case("llama3-8b B1 S256", 1, 256, 32, 8, 128),
        bwd_case("mqa H8 KV1", 2, 256, 8, 1, 128),
        bwd_case("non-causal", 2, 256, 8, 2, 128, causal=False),
        bwd_case("window64+softcap50", 2, 256, 8, 2, 128, window=64,
                 softcap=50.0),
        bwd_case("D64", 2, 256, 8, 2, 64),
        bwd_case("gemma-2b train B2 S2048", 2, 2048, 8, 1, 256, timed=True),
        bwd_case("gemma-7b heads H16 KV16", 2, 256, 16, 16, 256),
        bwd_case("D256 non-causal", 1, 160, 4, 2, 256, causal=False),
        bwd_case("D256 window96+softcap30", 1, 320, 4, 1, 256, window=96,
                 softcap=30.0),
    ]
    # The kernels line's timed case stays the Llama train shape; the Gemma-2B
    # train shape's times go beside it.
    gemma = {}
    for key in ("dq", "dkv"):
        r = bwd[7][key]
        gemma.update({f"gemma2b_{key}_{f}": r.pop(f) for f in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "delta_ms",
            "pair_with_delta_ms", "flash_backward_ms") if f in r})
    emit("flash_bwd_gemma2b", shape="B=2 S=2048 H=8 KV=1 D=256, causal", **gemma)
    results["flash_bwd_dq"] = [r["dq"] for r in bwd]
    results["flash_bwd_dkv"] = [r["dkv"] for r in bwd]
    results["flash_bwd_extra"] = {
        **{f"llama3_8b_{f}": bwd[0]["dq"][f] for f in (
            "delta_ms", "pair_with_delta_ms", "flash_backward_ms")}, **gemma}
    return results


KERNEL_CLASSES = ("paged_decode", "dense_decode", "flash_fwd", "flash_bwd_dq",
                  "flash_bwd_dkv")


def profiled(window: str, fn, **fields) -> None:
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
    emit("profile", window=window, **fields,
         wall_ms=round(wall * 1e3, 3), device_busy_ms=round(busy, 3),
         device_idle_share=round(1 - busy / (wall * 1e3), 4),
         by_class_ms={k: round(v, 3) for k, v in classes.items()},
         top=[{"kernel": e.key[:80], "ms": round(dev_us(e) / 1e3, 3),
               "count": e.count} for e in top])


def window_rounds(steps: int) -> int:
    """Rounds of a profiled decode window: at least 48 decode steps and
    two rounds, so that one round's host jitter weighs little."""
    return max(2, -(-48 // steps))


def profile_rounds(params, cfg, kw, rng, lanes: int = 8, model: str = "gemma_2b") -> dict:
    """Where a decode round's device time goes: ``lanes`` requests (prompts
    of 500-1000 tokens) admitted and two rounds run (the warm-up chunk,
    then the capture and the first replay), then :func:`window_rounds`
    more under the profiler, all graph replays. Budgets outlast the
    window."""
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    srv = GenerationServer(params, cfg, **kw)
    steps = srv.stats()["decode_steps"] * kw["chunk"]
    n_rounds = window_rounds(steps)
    for n in rng.integers(500, 1001, lanes):
        srv.submit(rng.integers(0, cfg.vocab_size, n), (n_rounds + 3) * steps)
    srv.step()  # admission of every request the server holds, and a chunk
    srv.step()
    busy = srv.stats()["lanes_busy_peak"]

    def rounds():
        for _ in range(n_rounds):
            srv.step()

    arena = (f"paged pool, tile {kw['kv_block_size']}" if "kv_pool_tokens" in kw
             else "slotted arena")
    loop = "overlapped" if srv.overlap else "lock-step"
    fields = dict(model=model, loop=loop,
                  decode_steps=srv.stats()["decode_steps"], lanes=busy,
                  rounds=n_rounds)
    profiled(f"{n_rounds} {loop} decode rounds ({n_rounds * steps} steps), "
             f"{arena}, {busy} of {kw['max_batch']} lanes busy, prompts "
             "500-1000", rounds, **fields)
    del srv
    return fields


def crosscheck(params, cfg, prompt, buckets, max_len: int,
               decode: bool = True) -> dict:
    """One request through the kernel path and the plain path.

    Inside the model, each layer's kernel call (prefill, then the first
    decode step) is held against the plain version on the same inputs —
    the main path's own shapes and strided layouts — with
    ``attention.kernel_tolerance``. End to end, the kernel path's
    last-position prefill logits and first decode step's logits are held
    against the plain path's, within LOGIT_BOUND x the plain logits' RMS;
    both decode steps start from the kernel path's caches, so the decode
    comparison sees only the decode attention. Greedy agreement over 16
    more steps is printed, not asserted: random weights make near-ties.
    ``decode=False`` (a config whose decode runs the plain attention on
    both paths) checks the prefill alone."""
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
    kernel_fn = (attention.make_decode_attn_fn(cfg, arena_len=max_len,
                                               device="cuda") if decode else None)
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
    _, la, _ = prefill_batch(params, toks, cfg, max_len, tl, attn_fn=plain_fp32_p,
                             kv_quantized=True)
    row = {"prompt_len": n, "logit_bound_x_rms": LOGIT_BOUND}
    compared = [("prefill", lk, lp, la)]
    if not decode:
        _compare(row, compared, layer_checks)
        emit("crosscheck", **row)
        return row
    first = torch.argmax(lk, -1).to(torch.int32)

    def step(caches, fn, attn_fn=ref):
        logits, _ = forward(params, first[:, None], cfg, attn_fn=attn_fn,
                            positions=pos[:, None], kv_caches=caches,
                            cache_offset=pos, decode_kernel_fn=fn)
        return logits[:, -1]

    cd = tuple(type(c)(*(t.clone() for t in c)) for c in ck)
    ca = tuple(type(c)(*(t.clone() for t in c)) for c in ck)
    dk, dp = step(ck, checked_decode), step(cd, None)
    da = step(ca, None, plain_fp32_p)
    nxt = torch.argmax(dk, -1).to(torch.int32)
    gk = _decode_scan(params, ck, nxt, pos + 1, cfg, 16, attn_fn=ref,
                      decode_kernel_fn=kernel_fn)
    gp = _decode_scan(params, cd, nxt, pos + 1, cfg, 16, attn_fn=ref)
    _compare(row, compared + [("decode", dk, dp, da)], layer_checks)
    row["greedy_agreement_16"] = float((gk == gp).float().mean())
    emit("crosscheck", **row)
    return row


def plain_fp32_p(q, k, v, **kw):
    """The plain attention with its probabilities kept in fp32 (the plain
    version rounds them to bf16 before the P.V product): an equally valid
    bf16 attention, whose distance from the plain path's logits is the
    noise floor that the model's depth makes of rounding alone."""
    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention

    return reference_attention(q.float(), k.float(), v.float(), **kw).to(q.dtype)


def _compare(row: dict, compared, layer_checks) -> None:
    for what, got, want, alt in compared:
        cases = layer_checks[what]
        row[f"{what}_layers_checked"] = len(cases)
        row[f"{what}_layer_max_err_over_bound"] = max(
            c["max_err_over_bound"] for c in cases)
        row[f"{what}_logit_err"] = float((got - want).abs().max())
        row[f"{what}_logit_rms"] = float(want.square().mean().sqrt())
        row[f"{what}_noise_err"] = float((alt - want).abs().max())


def assert_family_crosscheck(row: dict, n_layers: int) -> None:
    """Every layer's kernel call checked (within ``kernel_tolerance``, by
    :func:`check`), and the logits within the serving bound or within
    :data:`NOISE_FACTOR` x the run's noise floor; which held is recorded."""
    for what in ("prefill", "decode"):
        if f"{what}_layers_checked" not in row:
            continue
        if row[f"{what}_layers_checked"] != n_layers:
            raise AssertionError(f"{what}: {row[f'{what}_layers_checked']} layer "
                                 f"checks, want {n_layers}")
        err, rms = row[f"{what}_logit_err"], row[f"{what}_logit_rms"]
        noise = row[f"{what}_noise_err"]
        row[f"{what}_within_serving_bound"] = err <= LOGIT_BOUND[what] * rms
        row[f"{what}_err_over_noise"] = err / noise if noise else math.inf
        if not math.isfinite(err) or not (row[f"{what}_within_serving_bound"]
                                          or err <= NOISE_FACTOR * noise):
            raise AssertionError(f"{what} logits: kernel vs plain {row}")


def assert_crosscheck(row: dict, n_layers: int) -> None:
    for what in ("prefill", "decode"):
        if f"{what}_layers_checked" not in row:
            continue  # a prefill-only crosscheck
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


# Counters of stats() that run_requests reports for its timed run alone.
RUN_COUNTERS = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
                "preemptions", "decode_graph_replays")


def warm_server(srv) -> dict:
    """One short request through ``srv`` before it is timed, long enough
    for two dispatches: the server's eager warm-up chunk and its capture
    are one-time costs of a server (``decode_graph`` prints the capture's),
    not part of what its users wait for in a run. The latency summaries
    start afresh after it. Returns the stats after it."""
    import numpy as np

    from kata_xpu_device_plugin_tpu_torch.obs.metrics import Rolling

    steps = srv.stats()["decode_steps"] * srv.chunk
    srv.submit(np.arange(1, 101, dtype=np.int32), steps + 2)
    srv.run()
    srv._ttft, srv._tok_lat = Rolling(), Rolling()
    return srv.stats()


def run_requests(srv, prompts, budgets):
    """Warm the server (:func:`warm_server`), submit every request, reset
    the serving kernels' launch counts, drain the server, read the counts.
    Returns the outputs in submit order, the wall time, the launches and
    the server's stats, with :data:`RUN_COUNTERS` counted over this run
    alone; every request must return its budget of in-vocabulary tokens.
    A server whose decode runs the plain attention (by its config's rule)
    must launch the flash kernel and no decode kernel."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward

    kernels = {"flash_fwd": flash_forward, "paged_decode": paged_decode_attention,
               "dense_decode": decode_attention}
    base = warm_server(srv)
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
    life = srv.stats()
    stats = {**life, **{k: life[k] - base[k] for k in RUN_COUNTERS}}
    outs = [results[rid] for rid in rids]
    for rid, out, b in zip(rids, outs, budgets):
        if len(out) != int(b):
            raise AssertionError(f"request {rid}: {len(out)} tokens, budget {b}")
        if not ((out >= 0) & (out < srv.cfg.vocab_size)).all():
            raise AssertionError(f"request {rid}: token out of vocabulary")
    kernel = stats["decode_backend"] == "cuda_paged"
    want = {"flash_fwd", "paged_decode"} if kernel else {"flash_fwd"}
    if set(launches) != want:
        raise AssertionError(f"serving ({stats['decode_backend']} decode) must "
                             f"launch {sorted(want)} and no other: {launches}")
    rounds, steps = stats["rounds"], stats["decode_steps"] * srv.chunk
    if kernel and launches["paged_decode"] != rounds * steps * srv.cfg.n_layers:
        raise AssertionError(f"a decode step left the paged kernel: {launches}, "
                             f"{rounds} rounds of {steps} steps")
    if (life["decode_graph_captures"] != 1
            or life["decode_graph_replays"] != life["rounds"] - 1
            or stats["decode_graph_replays"] != rounds):
        raise AssertionError(f"every chunk after the warm-up must be a graph "
                             f"replay: {life}")
    return outs, wall, launches, stats


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
        decode_steps=stats["decode_steps"],
        decode_graph={k: stats[f"decode_graph_{k}"] for k in (
            "captures", "replays", "capture_s", "pool_bytes")},
        arena_bytes=stats["arena_bytes"],
        peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=launches)


SIDE_KEYS = ("tok_s", "wall_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
             "itl_p99_s", "rounds", "prefill_batches", "decode_steps",
             "decode_graph", "launches")


def _bits(t):
    """A tensor's bytes as integers, so that equality is bit equality."""
    import torch

    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def graph_check(params, cfg, kw, seed: int = 0) -> dict:
    """One decode chunk by CUDA graph against the same chunk run eagerly:
    a server with ``kw`` admits 8 requests and decodes its warm-up chunk
    (lock-step), then the second chunk is run eagerly on a clone of the
    arena and through the server's graph (its capture, then its first
    replay) on the live arena, from the same inputs. Tokens, ``last``,
    ``pos`` and every byte of the arena must be equal. A sampling server's
    generator is set back (``get_state``/``set_state``) to its state before
    the eager chunk ahead of each replay, so the replay draws the same
    numbers; one more replay without that must draw fresh ones."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import serve_decode
    from kata_xpu_device_plugin_tpu_torch.guest.kv_arena import SCRATCH_BLOCK
    from kata_xpu_device_plugin_tpu_torch.ops.quant import QTensor

    srv = GenerationServer(params, cfg, **{**kw, "overlap": False})
    rng = np.random.default_rng(seed)
    for n in rng.integers(64, 1001, 8):
        srv.submit(rng.integers(0, cfg.vocab_size, n), 64)
    srv.step()
    srv._ensure_blocks()
    arena = srv.kv_pool.arena if srv.paged else srv.arena
    leaves = [t for c in arena for t in (c if isinstance(c, QTensor) else (c,))]
    clone = [t.clone() for t in leaves]
    it = iter(clone)
    eager_arena = tuple(type(c)(*(next(it) for _ in c)) if isinstance(c, QTensor)
                        else next(it) for c in arena)

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to("cuda")

    extra = {}
    if srv._decode_steps > 1:
        extra["budget"] = dev(srv._decode_budget())
    if srv.paged:
        extra["block_tables"] = dev(srv._bt_host)
    exe = srv._decode
    tok, pos = dev(srv._last), dev(srv._pos)
    gen = srv.generator if srv._do_sample else None
    state = gen.get_state() if gen is not None else None

    def restore():
        if gen is not None:
            gen.set_state(state)

    t0 = time.perf_counter()
    want = serve_decode(params, eager_arena, tok, pos, cfg, exe.steps,
                        exe.decode_kernel_fn, **extra, **exe._kw)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    restore()
    got = exe(tok, pos, **extra)
    torch.cuda.synchronize()
    first = [t.clone() for t in got]
    restore()
    t0 = time.perf_counter()
    exe(tok, pos, **extra)  # a second replay, timed (it rewrites the same rows)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    outs_equal = all(torch.equal(g, w) for g, w in zip(first, want)) and all(
        torch.equal(g, w) for g, w in zip(got, want))
    # The second replay rewrote the rows the first wrote, with equal values.
    # A paged server's dead lanes all write the scratch block, which nothing
    # reads: greedy, they write equal values there; sampled, each draws its
    # own tokens, so which of the duplicate writes lands is not fixed. A
    # sampled paged check holds every byte but the scratch block's.
    scratch = None
    if gen is not None and srv.paged:
        bs = srv.kv_block
        scratch = slice(SCRATCH_BLOCK * bs, (SCRATCH_BLOCK + 1) * bs)
        scratch_equal = all(torch.equal(_bits(a[:, :, scratch]),
                                        _bits(c[:, :, scratch]))
                            for a, c in zip(leaves, clone))
        for a, c in zip(leaves, clone):
            c[:, :, scratch] = a[:, :, scratch]
    arena_equal = all(torch.equal(_bits(a), _bits(c)) for a, c in zip(leaves, clone))
    fresh = None
    if gen is not None:  # no restore: the generator has moved on
        fresh = not torch.equal(exe(tok, pos, **extra)[0], first[0])
    row = dict(arena="paged" if srv.paged else "slotted",
               sampled=gen is not None, fresh_draws_without_restore=fresh,
               scratch_block_bit_equal=None if scratch is None else scratch_equal,
               kv_quant=srv.stats()["kv_quant"], steps=exe.steps,
               lanes=sum(r is not None for r in srv._slot_req),
               outputs_bit_equal=outs_equal, arena_bit_equal=arena_equal,
               arena_bytes_compared=sum(t.numel() * t.element_size() for t in leaves),
               captures=exe.captures, replays=exe.replays,
               capture_s=round(exe.capture_s, 4), graph_pool_bytes=exe.pool_bytes,
               eager_chunk_s=round(eager_s, 6), replay_chunk_s=round(replay_s, 6))
    emit("graph_check", **row)
    replays = 3 if gen is not None else 2
    if (not (outs_equal and arena_equal) or fresh is False
            or (exe.captures, exe.replays) != (1, replays)):
        raise AssertionError(f"graph replay differs from the eager chunk: {row}")
    return row


def phase_serve(params, cfg, seed: int = 0, profile: bool = False) -> dict:
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    kw = dict(max_batch=8, **SERVE_KW)
    rng = np.random.default_rng(seed)
    rng.integers(0, cfg.vocab_size, 100)  # skipped: the requests stay those PERF.md records

    lens = rng.integers(64, 1001, 16)
    budgets = rng.integers(64, 129, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    mem0 = torch.cuda.memory_allocated()
    srv = GenerationServer(params, cfg, **kw)
    outs, wall, launches, stats = run_requests(srv, prompts, budgets)
    if (stats["decode_backend"] != attention.BACKEND_PAGED
            or stats["kv_quant"] != "int8" or not srv.overlap):
        raise AssertionError(f"unexpected server mode: {stats}")
    row = serve_row(stats, wall, budgets, lens, launches)
    del srv
    lock = GenerationServer(params, cfg, overlap=False, **kw)
    outs_l, wall_l, launches_l, stats_l = run_requests(lock, prompts, budgets)
    del lock
    # The arenas and the graphs' pools go with their servers.
    torch.cuda.synchronize()
    emit("serve", loop="overlapped", **row,
         allocated_after_servers_freed_bytes=torch.cuda.memory_allocated() - mem0,
         lockstep_same_requests={k: v for k, v in serve_row(
             stats_l, wall_l, budgets, lens, launches_l).items() if k in SIDE_KEYS},
         token_match_vs_lockstep=token_match(outs, outs_l, budgets))
    graph_check(params, cfg, kw)

    rows = [crosscheck(params, cfg, prompts[i], kw["prefill_buckets"], kw["max_len"])
            for i in (0, 1)]
    for row in rows:
        assert_crosscheck(row, cfg.n_layers)
    if profile:
        for overlap in (True, False):
            profile_rounds(params, cfg, dict(kw, overlap=overlap), rng)
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
    kernel_fn, cases = srv._decode.decode_kernel_fn, []
    kw = dict(block_size=PAGED_KW["kv_block_size"], paged_len=SERVE_KW["max_len"])

    def checked(q, ck, cv, tables, pos, q_lens=None):
        out = kernel_fn(q, ck, cv, tables, pos, q_lens)
        ref = paged_decode_reference(q, ck, cv, tables, pos, q_lens, **kw)
        mag = paged_decode_reference(q.float(), ck, v_abs(cv), tables, pos,
                                     q_lens, **kw)
        cases.append(check("paged layer", out, ref, mag))
        return out

    srv._decode.decode_kernel_fn = checked
    srv.step()  # admission of the first lanes, then the eager warm-up chunk
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
    """32 requests over the paged pool (the default, overlapped loop), then
    the same requests through the lock-step paged server and the paged
    server at ``decode_steps=4``, then over the slotted arena for the
    token-match fraction (printed, not asserted: the two servers batch
    differently, cuBLAS may pick another kernel per batch size, the tiles
    differ, and random weights turn one differing rounding into another
    continuation). A last run puts the fraction in proportion: a paged
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
    sides = {}
    for name, extra in (("lockstep", dict(overlap=False)),
                        ("decode_steps_4", dict(decode_steps=4))):
        side = GenerationServer(params, cfg, **PAGED_KW, **SERVE_KW, **extra)
        outs_x, wall_x, launches_x, stats_x = run_requests(side, prompts, budgets)
        del side
        sides[name] = {
            **{k: v for k, v in serve_row(stats_x, wall_x, budgets, lens,
                                          launches_x).items() if k in SIDE_KEYS},
            "preemptions": stats_x["preemptions"],
            "token_match_vs_default": token_match(outs_x, outs, budgets)}
    graph_check(params, cfg, dict(**PAGED_KW, **SERVE_KW))
    slotted = GenerationServer(params, cfg, max_batch=8, **SERVE_KW)
    outs_s, wall_s, launches_s, stats_s = run_requests(slotted, prompts, budgets)
    slotted_row = serve_row(stats_s, wall_s, budgets, lens, launches_s)
    del slotted
    twin_kw = dict(max_batch=8, kv_pool_tokens=8 * 2048 + 2 * 128,
                   kv_block_size=128)
    twin = GenerationServer(params, cfg, **twin_kw, **SERVE_KW)
    outs_t, wall_t, _, stats_t = run_requests(twin, prompts, budgets)
    del twin
    emit("paged", config=PAGED_KW, loop="overlapped", **row,
         token_match_vs_slotted=token_match(outs, outs_s, budgets),
         **{f"{k}_same_requests": v for k, v in sides.items()},
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
    paged_crosscheck(params, cfg, prompts[:12], budgets[:12])
    if profile:
        for overlap in (True, False):
            profile_rounds(params, cfg, dict(**PAGED_KW, **SERVE_KW, overlap=overlap),
                           rng, lanes=16)
    return launches


# ----- persistent rounds and admission scheduling ----------------------------


def phase_requests(n: int, vocab: int, seed: int = 0, skip: int = 0):
    """The serving phases' requests: ``n`` prompts of 64-1000 tokens with
    budgets of 64-128, from ``seed`` (``skip`` draws thrown away first, as
    the serve phase does): the serve phase's with ``n=16, skip=100``, the
    paged phase's with ``n=32``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if skip:
        rng.integers(0, vocab, skip)
    lens = rng.integers(64, 1001, n)
    budgets = rng.integers(64, 129, n)
    prompts = [rng.integers(0, vocab, k).astype(np.int32) for k in lens]
    return prompts, budgets, lens


# Counters of a persistent server that run_persistent reports for its
# timed run alone.
PERSISTENT_COUNTERS = ("rounds", "prefills", "tokens_emitted", "preemptions",
                       "persistent_rounds", "delivered_steps_total",
                       "delivered_lane_steps", "persistent_steps_executed",
                       "persistent_graph_replays")


def run_persistent(srv, prompts, budgets):
    """:func:`run_requests` for a persistent server. Its warm-up is two
    short requests of unequal budgets: the first round runs eagerly and
    ends when the shorter one finishes, the second captures the round's
    graph, so every round of the timed run is replays. Asserted: every
    budget returned in vocabulary; the exits partition the rounds, every
    round persistent; the tokens the rounds delivered to live lanes are
    the tokens emitted past each request's first; the paged kernel's
    launches are the steps executed x layers, counted through replays,
    one replay a group of ``sub_steps``; fewer than ``sub_steps`` steps
    a round ran past its exit."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.obs.metrics import Rolling
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward

    kernels = {"flash_fwd": flash_forward, "paged_decode": paged_decode_attention,
               "dense_decode": decode_attention}
    for b in (4, 12):
        srv.submit(np.arange(1, 101, dtype=np.int32), b)
    srv.run()
    srv._ttft, srv._tok_lat = Rolling(), Rolling()
    base = srv.stats()
    rids = [srv.submit(p, int(b)) for p, b in zip(prompts, budgets)]
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    life = srv.stats()
    st = {**life, **{k: life[k] - base[k] for k in PERSISTENT_COUNTERS}}
    st["persistent_exits"] = {k: v - base["persistent_exits"][k]
                              for k, v in life["persistent_exits"].items()}
    outs = [results[r] for r in rids]
    for rid, out, b in zip(rids, outs, budgets):
        if len(out) != int(b) or not ((out >= 0) & (out < srv.cfg.vocab_size)).all():
            raise AssertionError(f"request {rid}: {len(out)} tokens, budget {b}")
    sub = st["sub_steps"] = srv._round.sub_steps
    executed, rounds = st["persistent_steps_executed"], st["persistent_rounds"]
    st["steps_past_exit"] = executed - st["delivered_steps_total"]
    problems = []
    if set(launches) != {"flash_fwd", "paged_decode"}:
        problems.append(f"launches {launches}")
    if launches.get("paged_decode") != executed * srv.cfg.n_layers:
        problems.append(f"paged launches {launches} for {executed} steps")
    if base["persistent_graph_captures"] != 1 or life["persistent_graph_captures"] != 1:
        problems.append("not one capture, in the warm-up")
    if st["persistent_graph_replays"] * sub != executed:
        problems.append("a round of the timed run left the graph")
    if sum(st["persistent_exits"].values()) != rounds or rounds != st["rounds"]:
        problems.append(f"exits {st['persistent_exits']} over {rounds} rounds")
    if st["tokens_emitted"] - st["prefills"] != st["delivered_lane_steps"]:
        problems.append("delivered tokens are not the tokens emitted")
    if not 0 <= st["steps_past_exit"] <= rounds * (sub - 1):
        problems.append(f"{st['steps_past_exit']} steps past exits")
    if problems:
        raise AssertionError(f"persistent serving: {problems}: {st}")
    return outs, wall, launches, st


def checked_paged(kernel_fn, cases: list, block_size: int, paged_len: int):
    """``kernel_fn`` (a server's paged decode function) with every call
    held against the plain version on its own inputs, appended to
    ``cases``. Eager only: a check reads its result on the host."""
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import paged_decode_reference

    def checked(q, ck, cv, tables, pos, q_lens=None):
        out = kernel_fn(q, ck, cv, tables, pos, q_lens)
        if tables is None:  # the slotted arena through its pool view
            return out
        kw = dict(block_size=block_size, paged_len=paged_len)
        ref = paged_decode_reference(q, ck, cv, tables, pos, q_lens, **kw)
        mag = paged_decode_reference(q.float(), ck, v_abs(cv), tables, pos,
                                     q_lens, **kw)
        cases.append(check("persistent layer", out, ref, mag))
        return out

    return checked


def persistent_graph_check(params, cfg, kw, seed: int = 0) -> dict:
    """A persistent round by CUDA graph against the same round eager: a
    persistent server admits 8 requests and runs its first round eagerly,
    each layer's paged kernel call held against the plain version (paged
    only; the slotted view's tables are synthetic); then the second round
    runs eagerly (``_decode_while``) on a clone of the arena and through
    the server's graph (its capture, then replays) on the live arena,
    from the same inputs. Tokens, ``delivered``, ``tok``, ``pos`` and
    every arena byte must be equal, and the graph's kernel launches the
    steps it executed x layers."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models.transformer import _decode_while
    from kata_xpu_device_plugin_tpu_torch.ops import attention
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import paged_decode_attention
    from kata_xpu_device_plugin_tpu_torch.ops.quant import QTensor

    srv = GenerationServer(params, cfg, persistent=True, **kw)
    rng = np.random.default_rng(seed)
    # Round 1 ends when the first request finishes (19 steps), round 2
    # when the second does (40 more); the rest outlast both.
    for n, b in zip(rng.integers(64, 1001, 8), (20, 60) + (300,) * 6):
        srv.submit(rng.integers(0, cfg.vocab_size, n), b)
    rnd, cases = srv._round, []
    kernel_fn = rnd.decode_kernel_fn
    rnd.decode_kernel_fn = checked_paged(kernel_fn, cases, srv.kv_block,
                                         srv.max_len)
    srv.step()  # admission, then the first round, eager
    rnd.decode_kernel_fn = kernel_fn
    first, first_executed = srv.stats(), rnd.executed
    srv._ensure_blocks()
    arena = srv.kv_pool.arena if srv.paged else srv.arena
    leaves = [t for c in arena for t in (c if isinstance(c, QTensor) else (c,))]
    clone = [t.clone() for t in leaves]
    it = iter(clone)
    eager_arena = tuple(type(c)(*(next(it) for _ in c)) if isinstance(c, QTensor)
                        else next(it) for c in arena)

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to("cuda")

    tok, pos, budget = dev(srv._last), dev(srv._pos), dev(srv._decode_budget())
    window = dev(srv._persistent_window())
    tables = dev(srv._bt_host) if srv.paged else None
    t0 = time.perf_counter()
    want = _decode_while(params, eager_arena, tok, pos, budget, window, cfg,
                         rnd.cap, attn_fn=attention.reference_attention,
                         block_tables=tables, decode_kernel_fn=kernel_fn,
                         sub_steps=rnd.sub_steps, **rnd._kw)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    d0 = paged_decode_attention.launches
    t0 = time.perf_counter()
    out, g_tok, g_pos, delivered = rnd(tok, pos, budget, window, tables)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    launched = paged_decode_attention.launches - d0
    w_out, _, w_tok, w_pos, w_delivered = want
    d = int(w_delivered)
    outs_equal = (delivered == d and torch.equal(out[:, :d], w_out[:, :d])
                  and torch.equal(g_tok, w_tok) and torch.equal(g_pos, w_pos))
    arena_equal = all(torch.equal(_bits(a), _bits(c)) for a, c in zip(leaves, clone))
    row = dict(arena="paged" if srv.paged else "slotted",
               first_round_delivered=first["delivered_steps"],
               first_round_executed=first_executed,
               first_round_layer_checks=len(cases),
               first_round_max_err_over_bound=max(
                   (c["max_err_over_bound"] for c in cases), default=None),
               delivered=d, executed=rnd.executed, sub_steps=rnd.sub_steps,
               cap=rnd.cap, outputs_bit_equal=outs_equal,
               arena_bit_equal=arena_equal,
               arena_bytes_compared=sum(t.numel() * t.element_size() for t in leaves),
               graph_launches=launched, captures=rnd.captures,
               replays=rnd.replays, capture_s=round(rnd.capture_s, 4),
               graph_pool_bytes=rnd.pool_bytes, eager_round_s=round(eager_s, 6),
               graph_round_s=round(graph_s, 6))
    emit("persistent_graph_check", **row)
    want_checks = first_executed * cfg.n_layers if srv.paged else 0
    if (not (outs_equal and arena_equal) or d < 1
            or launched != rnd.executed * cfg.n_layers
            or (rnd.captures, rnd.replays) != (1, rnd.executed // rnd.sub_steps)
            or len(cases) != want_checks):
        raise AssertionError(f"persistent round by graph differs from eager: {row}")
    return row


def phase_persistent(params, cfg, seed: int = 0) -> dict:
    """Persistent rounds, slotted (the serve phase's 16 requests) and over
    the paged pool (the paged phase's 32), each beside the lock-step
    server on the same requests and config, whose tokens they must equal;
    then :func:`persistent_graph_check` for both arenas."""
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    launches = {}
    for arena, kw, n, skip in (
            ("slotted", dict(max_batch=8, **SERVE_KW), 16, 100),
            ("paged", dict(**PAGED_KW, **SERVE_KW), 32, 0)):
        prompts, budgets, lens = phase_requests(n, cfg.vocab_size, seed, skip)
        srv = GenerationServer(params, cfg, persistent=True, **kw)
        outs, wall, got, st = run_persistent(srv, prompts, budgets)
        del srv
        lock = GenerationServer(params, cfg, overlap=False, **kw)
        outs_l, wall_l, launches_l, st_l = run_requests(lock, prompts, budgets)
        del lock
        match = token_match(outs, outs_l, budgets)
        rounds = st["persistent_rounds"]
        row = serve_row(st, wall, budgets, lens, got)
        row.pop("decode_graph")
        emit("persistent", arena=arena, config=kw, **row,
             persistent_cap=st["persistent_cap"],
             sub_steps=st["sub_steps"],
             exits=st["persistent_exits"],
             mean_delivered_per_round=round(st["delivered_steps_total"] / rounds, 3),
             steps_executed=st["persistent_steps_executed"],
             steps_past_exit=st["steps_past_exit"],
             preemptions=st["preemptions"],
             persistent_graph_replays=st["persistent_graph_replays"],
             lockstep_same_requests={k: v for k, v in serve_row(
                 st_l, wall_l, budgets, lens, launches_l).items() if k in SIDE_KEYS}
             | {"preemptions": st_l["preemptions"]},
             token_match_vs_lockstep=match)
        if match["requests_identical"] != len(budgets):
            raise AssertionError(f"persistent tokens differ from lock-step: {match}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        persistent_graph_check(params, cfg, kw, seed)
    return launches


@contextlib.contextmanager
def checking_flash(cases: list):
    """Within the block, every flash forward the model's prefill makes
    (``ops.attention.flash_attention``) is held against the plain version
    on its own inputs, appended to ``cases``."""
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    orig, ref = attention.flash_attention, attention.reference_attention

    def checked(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        mag = ref(q.float(), k.float(), v.abs().float(), **kw)
        cases.append(check("sched prefill layer", out, ref(q, k, v, **kw), mag))
        return out

    attention.flash_attention = checked
    try:
        yield cases
    finally:
        attention.flash_attention = orig


def first_difference_margin(params, cfg, prompts, outs, other) -> dict:
    """Where two servers' tokens first part: the request, the token's
    index, and the top-2 margin of the plain path's logits there (the
    prompt and the shared tokens before it through a plain prefill);
    None when they never part."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import prefill
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    for i, (a, b) in enumerate(zip(outs, other)):
        diff = np.flatnonzero(a != b)
        if not len(diff):
            continue
        j = int(diff[0])
        ctx = np.concatenate([prompts[i], a[:j]]).astype(np.int64)
        toks = torch.from_numpy(ctx)[None].to("cuda")
        _c, logits, _p = prefill(params, toks, cfg, len(ctx),
                                 attn_fn=attention.reference_attention,
                                 return_logits=True, kv_quantized=True)
        top = torch.topk(logits[0], 2).values
        return {"request": i, "index": j, "tokens": [int(a[j]), int(b[j])],
                "plain_top2_margin": float(top[0] - top[1])}
    return None


def chunked_first_logits(params, cfg, firsts, quantized: bool) -> dict:
    """Each chunked admission's first-token logits (``firsts``: prompt and
    logits) against three whole prefills of its prompt on the plain path,
    with the server's KV cache (int8 when ``quantized``, else bf16):
    ``plain``, the plain prefill, which attends over the fresh bf16 k/v;
    ``readback``, the prompt as one ``prefill_suffix`` slice from empty
    caches, which attends over the cache read back, as every chunk does
    (here and in the JAX package); ``fp32_p``, the plain prefill with fp32
    probabilities, whose distance from ``plain`` is the noise floor
    rounding alone makes at this depth. Errors are max |difference| over
    the ``plain`` logits' RMS. Held within the serving bound: the chunks
    against the one-slice read-back, and, with a bf16 cache (whose
    read-back rows are the fresh k/v), against the plain prefill. An int8
    cache's read-back rounds every k/v row, and that alone moves the
    logits past the serving bound on these random weights
    (``readback_vs_plain``, printed)."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        init_kv_caches,
        prefill_batch,
        prefill_suffix,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    bound = LOGIT_BOUND["prefill"]
    rows = []
    for prompt, got in firsts:
        n = len(prompt)
        pad = next(b for b in SERVE_KW["prefill_buckets"] if b >= n)
        toks = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
        toks[0, :n] = torch.from_numpy(prompt)
        tl = torch.tensor([n], dtype=torch.int32)
        whole = {}
        for name, fn in (("plain", attention.reference_attention),
                         ("fp32_p", plain_fp32_p)):
            whole[name] = prefill_batch(params, toks, cfg, SERVE_KW["max_len"],
                                        tl, attn_fn=fn, kv_quantized=quantized)[1]
        caches = init_kv_caches(cfg, 1, SERVE_KW["max_len"], device="cuda",
                                quantized=quantized)
        whole["readback"] = prefill_suffix(params, toks.long(), cfg, caches, 0,
                                           return_logits=True, true_len=n)[1]
        rms = float(whole["plain"].square().mean().sqrt())

        def err(a, b):
            return float((a - b).abs().max()) / rms

        row = {"prompt_len": n, "vs_plain": err(got, whole["plain"]),
               "vs_readback": err(got, whole["readback"]),
               "readback_vs_plain": err(whole["readback"], whole["plain"]),
               "noise_floor": err(whole["fp32_p"], whole["plain"])}
        row["ok"] = (math.isfinite(row["vs_plain"]) and row["vs_readback"] <= bound
                     and (quantized or row["vs_plain"] <= bound))
        rows.append(row)
    keys = ("vs_plain", "vs_readback", "readback_vs_plain", "noise_floor")
    return {"kv": "int8" if quantized else "bf16", "compared": len(rows),
            "bound_x_rms": bound,
            **{f"max_{k}": max((r[k] for r in rows), default=None) for k in keys},
            "min_noise_floor": min((r["noise_floor"] for r in rows), default=None),
            "ok": bool(rows) and all(r["ok"] for r in rows), "per_admission": rows}


def phase_sched(params, cfg, seed: int = 0) -> dict:
    """Admission scheduling on the serve phase's config and 16 requests:
    the ``fifo_batch`` server, then ``slo_chunked`` with ``itl_slo_ms=0``
    (maximal chunking) and ``prefill_chunk=128``, fused and not, at the
    default deadline, and fused over a bf16 cache. Each run is timed
    (tok/s, TTFT, ITL) and its tokens matched against the fifo server's,
    with the plain top-2 margin where they first part. Asserted: chunks ran, fused ones rode decode
    dispatches; every chunked admission's first-token logits held
    against whole plain prefills of its prompt
    (:func:`chunked_first_logits`); every flash call of a whole admission
    pass within ``kernel_tolerance`` of the plain version."""
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    kw = dict(max_batch=8, **SERVE_KW)
    prompts, budgets, lens = phase_requests(16, cfg.vocab_size, seed, skip=100)
    fifo = GenerationServer(params, cfg, **kw)
    outs_f, wall_f, launches_f, st_f = run_requests(fifo, prompts, budgets)
    del fifo
    chunked = dict(sched_policy="slo_chunked", itl_slo_ms=0.0, prefill_chunk=128)
    runs = {"fused": dict(chunked, fused=True),
            "unfused": dict(chunked, fused=False),
            "default_slo": dict(sched_policy="slo_chunked"),
            "fused_bf16_kv": dict(chunked, fused=True, kv_quant=False)}
    launches, rows, firsts = dict(launches_f), {}, {True: [], False: []}
    for name, extra in runs.items():
        srv = GenerationServer(params, cfg, **kw, **extra)
        logits_seen, landed = [], []
        sample_first, commit = srv._sample_first, srv._commit_partial

        def recording_sample(logits, sample_first=sample_first, seen=logits_seen):
            seen.append(logits.float().clone())
            return sample_first(logits)

        def recording_commit(p, first, t, commit=commit, seen=logits_seen,
                             landed=landed):
            landed.append((p.req.prompt, seen[-1]))
            return commit(p, first, t)

        srv._sample_first, srv._commit_partial = recording_sample, recording_commit
        outs, wall, got, st = run_requests(srv, prompts, budgets)
        del srv
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if name != "default_slo":
            firsts[st["kv_quant"] == "int8"] += landed
        row = {k: v for k, v in serve_row(st, wall, budgets, lens, got).items()
               if k in SIDE_KEYS}
        row.update({k: st[k] for k in ("kv_quant", "sched_policy", "sched_chunks",
                                       "sched_defers", "fused_admissions",
                                       "slo_violations", "itl_slo_ms",
                                       "prefill_chunk_tokens")})
        row["chunked_admissions"] = len(landed)
        row["token_match_vs_fifo"] = token_match(outs, outs_f, budgets)
        row["first_difference"] = first_difference_margin(params, cfg, prompts,
                                                          outs, outs_f)
        rows[name] = row
    firsts_rows = [chunked_first_logits(params, cfg, firsts[q], q)
                   for q in (True, False)]
    cases = []
    srv = GenerationServer(params, cfg, **kw, **runs["fused"])
    for p, b in zip(prompts[:8], budgets[:8]):
        srv.submit(p, int(b))
    with checking_flash(cases):
        srv.step()  # the first admission pass: whole prefills, every layer checked
    del srv
    emit("sched", config=kw, requests=len(budgets),
         fifo_batch={k: v for k, v in serve_row(
             st_f, wall_f, budgets, lens, launches_f).items() if k in SIDE_KEYS},
         **rows, chunked_first_logits=firsts_rows,
         whole_admission_flash_checks=len(cases),
         whole_admission_flash_max_err_over_bound=max(
             (c["max_err_over_bound"] for c in cases), default=None))
    problems = []
    for name in ("fused", "unfused", "fused_bf16_kv"):
        if rows[name]["sched_chunks"] < 1 or rows[name]["chunked_admissions"] < 1:
            problems.append(f"{name}: no chunked admission")
    if (rows["fused"]["fused_admissions"] < 1 or rows["unfused"]["fused_admissions"]
            or rows["fused_bf16_kv"]["fused_admissions"] < 1):
        problems.append("fused admissions")
    for row in firsts_rows:
        if not row["ok"]:
            problems.append(f"chunked first-token logits {row}")
    if len(cases) < cfg.n_layers:
        problems.append(f"{len(cases)} flash checks")
    if problems:
        raise AssertionError(f"sched: {problems}")
    return launches


# The families served at their published widths (random bf16 weights from
# seed 0, fused) by the default server over a paged pool: model -> the cut
# of its depth (with the window and rope cycles cut with it), max_len, and
# how many of its 16 prompts are long (4200-6000 tokens; the rest 64-1000).
LONG_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 6144, 8192)
FAMILIES = {
    "gemma2_2b": dict(layers=None, max_len=8192, long=4),
    "qwen2_7b": dict(layers=None, max_len=2048, long=0),
    "gemma3_4b": dict(layers=6, max_len=2048, long=0),
    "mistral_7b": dict(layers=4, max_len=8192, long=4),
}
SAMPLE_KW = dict(temperature=0.7, top_k=50, top_p=0.9, seed=0)


def family_config(name: str, layers):
    """The family's published config, its depth cut to ``layers`` with its
    per-layer cycles cut to their first ``layers`` entries."""
    from kata_xpu_device_plugin_tpu_torch import models

    cfg = getattr(models, name)()
    if layers is None:
        return cfg, f"none: all {cfg.n_layers} layers"
    cut = {"n_layers": layers}
    for f in ("attn_windows", "rope_theta_cycle", "rope_linear_cycle"):
        if getattr(cfg, f):
            cut[f] = getattr(cfg, f)[:layers]
    return (replace(cfg, **cut),
            f"n_layers={layers} (from {cfg.n_layers}; the phase's share of the "
            "run's time), window and rope cycles cut to their first entries")


def phase_families(seed: int = 0, profile: bool = False) -> dict:
    """Each family of :data:`FAMILIES` through the default server (overlapped,
    K = 1, graphed, int8 KV, paged: 16 lanes, tile 16): 16 greedy requests
    (tok/s, TTFT, ITL, the decode backend and its reason, captures and
    replays, launches); the same requests sampled (``SAMPLE_KW``) by two
    servers of one seed, whose tokens must be equal; ``graph_check`` on a
    sampled chunk; the served prefill (and, where the decode kernel runs,
    the first decode step) of a request held against the plain path.
    Qwen2-7B decodes through the paged kernel at its group of 7; the
    windowed families decode with the plain attention by the JAX rule.
    Every family runs before any failure is raised. ``profile`` adds a
    profiled window of decode rounds of each (16 lanes busy)."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models import (
        fuse_decoder_params,
        init_params,
    )

    launches, failures = {}, []
    for name, spec in FAMILIES.items():
        cfg, reduced = family_config(name, spec["layers"])
        t0 = time.perf_counter()
        params = fuse_decoder_params(
            init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        max_len = spec["max_len"]
        buckets = tuple(b for b in LONG_BUCKETS if b <= min(max_len, 8192)
                        and (spec["long"] or b <= 1024))
        kw = dict(max_batch=16, max_len=max_len, prefill_buckets=buckets,
                  chunk=8, kv_pool_tokens=16 * max_len + 32, kv_block_size=16)
        rng = np.random.default_rng(seed)
        lens = rng.integers(64, 1001, 16)
        lens[: spec["long"]] = rng.integers(4200, 6001, spec["long"])
        budgets = rng.integers(64, 129, 16)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        windowed = any(w > 0 for w in cfg.window_cycle)
        want = ("reference", "sliding_window") if windowed else ("cuda_paged", "")
        srv = GenerationServer(params, cfg, **kw)
        outs, wall, fam_launches, stats = run_requests(srv, prompts, budgets)
        del srv
        got = (stats["decode_backend"], stats["decode_backend_reason"])
        if got != want or stats["kv_quant"] != "int8":
            failures.append(f"{name}: decode backend {got}, want {want}")
        row = serve_row(stats, wall, budgets, lens, fam_launches)
        launches[name] = fam_launches
        sampled = []
        for _ in range(2):
            side = GenerationServer(params, cfg, **kw, **SAMPLE_KW)
            outs_s, wall_s, _, stats_s = run_requests(side, prompts, budgets)
            sampled.append((outs_s, wall_s, stats_s))
            del side
        repeat = token_match(sampled[0][0], sampled[1][0], budgets)
        if repeat["requests_identical"] != len(budgets):
            failures.append(f"{name}: sampled runs of one seed differ {repeat}")
        gc_row = graph_check(params, cfg, dict(kw, **SAMPLE_KW), seed=seed)
        long_i = 0 if spec["long"] else int(np.argmax(lens))
        cc = crosscheck(params, cfg, prompts[long_i], buckets, max_len,
                        decode=not windowed)
        try:
            assert_family_crosscheck(cc, cfg.n_layers)
        except AssertionError as e:
            failures.append(f"{name}: {e}")
        emit("family", model=name, reduced=reduced, max_len=max_len,
             config=dict(kw), init_s=round(init_s, 3),
             prompt_lens=lens.tolist(), **row,
             decode_backend=got[0], decode_backend_reason=got[1],
             sampled=dict(SAMPLE_KW, tok_s=round(int(sum(budgets))
                                                  / sampled[0][1], 2),
                          itl_p50_s=sampled[0][2]["decode_token_s"]["p50"],
                          repeat=repeat,
                          token_match_vs_greedy=token_match(
                              sampled[0][0], outs, budgets)),
             graph_check_sampled=gc_row["outputs_bit_equal"]
             and gc_row["arena_bit_equal"],
             crosscheck={k: v for k, v in cc.items() if k != "logit_bound_x_rms"})
        if profile:
            profile_rounds(params, cfg, kw, rng, lanes=16, model=name)
        del params
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("families: " + "; ".join(failures))
    return launches


def phase_generate(params, cfg, seed: int = 0, phase: str = "generate") -> dict:
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
    emit(phase, layers=cfg.n_layers, H=cfg.n_heads, KV=cfg.n_kv_heads,
         D=cfg.head_dim, B=B, prompt=S, steps=steps, cache="bf16",
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


def phase_generate_qwen2(seed: int = 0) -> dict:
    """:func:`phase_generate` at Qwen2-7B's published widths with 4 of its
    28 layers: the dense decode kernel (and, without the opt-in, the paged
    kernel over the slotted re-view) at the group of 7."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models import (
        fuse_decoder_params,
        init_params,
        qwen2_7b,
    )

    cfg = qwen2_7b(n_layers=4)
    params = fuse_decoder_params(
        init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16))
    out = phase_generate(params, cfg, seed, phase="generate_qwen2")
    del params
    return out


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


TRAIN_MODELS = {  # model -> (layers of the published depth, why cut)
    "llama3_8b": (32, "one card's memory"),
    "gemma_2b": (18, "the phase's share of the run's time"),
}


def phase_train(model: str = "llama3_8b", n_layers: int = 8, steps: int = 6,
                seed: int = 0, profile: bool = False, phase: str = "train") -> dict:
    """``fit`` at ``model``'s published widths with ``n_layers`` of its
    layers on one batch of B=2 windows of 2048 tokens, seen every step.
    ``profile`` adds one more step under the profiler."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.ops import flash
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        TokenBatchLoader,
        fit,
        make_optimizer,
        make_train_step,
    )
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves

    cfg = getattr(models, model)(n_layers=n_layers)
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
        profiled(f"{model} train step {steps + 1}, B={B}, S={seq_len + 1}",
                 lambda: step(state, batch))
    del state
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    p50 = float(np.median(step_s))
    tokens = B * (seq_len + 1)
    flops = train_flops_per_step(cfg, B, seq_len + 1)
    full, why = TRAIN_MODELS[model]
    emit(phase, model=model, n_layers=n_layers,
         reduced=f"n_layers={n_layers} (from {full}; {why})", params=n_params,
         B=B, S=seq_len + 1, head_dim=cfg.head_dim, steps=steps, losses=losses,
         first_step_s=stamps[0] - t0, step_s=step_s, step_p50_s=p50,
         tokens_per_s=tokens / p50, model_flops_per_step=flops,
         mfu=flops / p50 / PEAK_BF16_FLOPS, peak_mem_bytes=peak,
         device_mem_bytes=torch.cuda.get_device_properties(0).total_memory,
         launches=launches)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase} loss not finite and falling: {losses}")
    want = steps * n_layers
    if any(n != want for n in launches.values()):
        raise AssertionError(f"{phase} launches {launches}, want {want} each")
    return launches


def train_crosscheck(model: str = "llama3_8b", seed: int = 1, n_layers: int = 2,
                     phase: str = "train_crosscheck") -> dict:
    """One ``next_token_loss`` backward at ``model``'s widths with
    ``n_layers`` layers, B=1, S=2048, through the kernels and through
    ``reference_attention``, from the same fp32 weights and tokens. On the
    kernel path each layer's forward (with lse) and backward kernel call is
    held against the plain version on its own inputs; the loss difference
    and the cosine of the whole gradient are printed, not bounded (random
    weights carry each layer's rounding on through the model)."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.models import init_params
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

    cfg = getattr(models, model)(n_layers=n_layers)
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
    row = {"model": model, "n_layers": n_layers, "B": 1, "S": 2048,
           "head_dim": cfg.head_dim, "loss_kernel": lk,
           "loss_plain": lp, "loss_diff": lk - lp, "grad_cosine": dot / (nk * np_),
           "layers_checked_fwd": len(checks["fwd"]),
           "layers_checked_bwd": len(checks["bwd"]),
           "fwd_max_err_over_bound": max(c["max_err_over_bound"] for c in checks["fwd"]),
           "lse_max_abs_err": max(c["lse_max_abs_err"] for c in checks["fwd"]),
           "bwd_max_err_over_bound": max(c[g]["max_err_over_bound"]
                                         for c in checks["bwd"] for g in c)}
    emit(phase, **row)
    if row["layers_checked_fwd"] != n_layers or row["layers_checked_bwd"] != n_layers:
        raise AssertionError(f"{phase} checked {row}")
    if not (math.isfinite(lk) and math.isfinite(row["grad_cosine"])):
        raise AssertionError(f"{phase} not finite: {row}")
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
    dense_extra = checks.pop("dense_decode_extra")
    bwd_extra = checks.pop("flash_bwd_extra")
    fwd_extra = checks.pop("flash_fwd_extra")
    params, cfg = timed_phase("serve_setup", gemma_setup)
    launches = {"serve": timed_phase("serve", phase_serve, params, cfg,
                                     profile=profile)}
    launches["paged"] = timed_phase("paged", phase_paged, params, cfg,
                                    profile=profile)
    launches["persistent"] = timed_phase("persistent", phase_persistent,
                                         params, cfg)
    launches["sched"] = timed_phase("sched", phase_sched, params, cfg)
    launches["generate"] = timed_phase("generate", phase_generate, params, cfg)
    del params
    torch.cuda.empty_cache()
    for name, n in timed_phase("families", phase_families,
                               profile=profile).items():
        launches[f"family_{name}"] = n
    launches["generate_qwen2"] = timed_phase("generate_qwen2",
                                             phase_generate_qwen2)
    torch.cuda.empty_cache()
    launches["train"] = timed_phase("train", phase_train, profile=profile)
    timed_phase("train_crosscheck", train_crosscheck)
    torch.cuda.empty_cache()
    launches["train_gemma"] = timed_phase(
        "train_gemma", phase_train, model="gemma_2b", n_layers=6, steps=4,
        profile=profile, phase="train_gemma")
    timed_phase("train_gemma_crosscheck", train_crosscheck, model="gemma_2b",
                phase="train_gemma_crosscheck")
    emit("seconds", **seconds, total=round(sum(seconds.values()), 2))
    src = f"{PKG}/csrc"
    jax_flash = "kata_xpu_device_plugin_tpu/ops/flash.py"
    meta = {
        "flash_fwd": dict(route="cuda", source=f"{src}/flash_fwd.cu",
                          replaces=f"{jax_flash}:70", extra=fwd_extra),
        "paged_decode": dict(route="cuda", source=f"{src}/paged_decode.cu",
                             replaces="kata_xpu_device_plugin_tpu/ops/decode_attn.py:213",
                             extra=extra),
        "dense_decode": dict(route="cuda", source=f"{src}/dense_decode.cu",
                             replaces="kata_xpu_device_plugin_tpu/ops/decode_attn.py:74",
                             extra=dense_extra),
        "flash_bwd_dq": dict(route="cuda", source=f"{src}/flash_bwd.cu",
                             replaces=f"{jax_flash}:219", extra=bwd_extra),
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
            "ms": timed["ms"], "call_ms": timed.get("call_ms"),
            "plain_ms": timed["plain_ms"],
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
