#!/usr/bin/env python3
"""The quantization quality ladder of the PyTorch port (counterpart of
``scripts/eval_quality.py``, the same flags, rungs and keys).

On a fixed token set, each rung against the full-precision baseline forward:

- ``int8``: weight-only int8 (``ops.quant.quantize_decoder_params``);
- ``w8a8``: the int8 tree with int8 x int8 products
  (``ops.quant.set_w8a8(True)``);
- ``int8_kv``: greedy decoding over an int8 KV cache against the model
  dtype's cache (``generate(kv_quantized=True)``).

The forward rungs report ``ce``/``delta_ce`` (next-token cross-entropy and
its drift; the tokens are random, so only the drift means anything),
``max_logit_drift``/``mean_logit_drift`` (|logit - baseline logit|) and
``top1_agree`` (argmax agreement); the KV rung its greedy token agreement
``kv_agree`` and the first step at which any row parts.

    python scripts/torch_eval_quality.py [--config llama3_train_test]
        [--dtype float32|bfloat16] [--batch 4] [--seq-len 128]
        [--decode-steps 64] [--seed 0] [--cpu]

One JSON line per rung on stdout, a summary on stderr. Without ``--cpu`` it
runs on the card: the forwards through the flash kernel, the decodes
through the paged decode kernel (the dense one under
``KATA_TPU_DECODE_KERNEL=1``, bf16 caches only); ``--seq-len`` must then be
a flash length (e.g. 128). Weights are random from ``--seed`` and the
tokens drawn by numpy from ``--seed + 1``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np


def ce_and_logits(params, cfg, inputs, targets: np.ndarray):
    """Mean next-token cross-entropy (computed on the host in fp32, as the
    JAX script does) and the fp32 logits of ``forward``."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import forward

    with torch.no_grad():
        lg = forward(params, inputs, cfg).float().cpu().numpy()
    lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) + lg.max(-1)
    ce = float(np.mean(lse - np.take_along_axis(
        lg, targets[..., None], axis=-1)[..., 0]))
    return ce, lg


def ladder(params, cfg, tokens: np.ndarray, decode_steps: int, config: str,
           dtype: str) -> list[dict]:
    """The four rungs' lines on ``tokens [B, S + 1]`` (int), on the params'
    device. ``config`` and ``dtype`` only label the lines."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.quant import (
        quantize_decoder_params,
        set_w8a8,
    )

    device = params["embed"].device
    toks = torch.as_tensor(np.asarray(tokens, np.int64), device=device)
    inputs, targets = toks[:, :-1], np.asarray(tokens)[:, 1:].astype(np.int64)
    lines = []

    def report(variant, ce, lg, base_ce, base_lg):
        drift = np.abs(lg - base_lg)
        lines.append({
            "variant": variant,
            "config": config,
            "dtype": dtype,
            "ce": round(ce, 6),
            "delta_ce": round(ce - base_ce, 6),
            "max_logit_drift": round(float(drift.max()), 6),
            "mean_logit_drift": round(float(drift.mean()), 6),
            "top1_agree": round(
                float((lg.argmax(-1) == base_lg.argmax(-1)).mean()), 6),
        })

    base_ce, base_lg = ce_and_logits(params, cfg, inputs, targets)
    report("baseline", base_ce, base_lg, base_ce, base_lg)
    qparams = quantize_decoder_params(params)
    report("int8", *ce_and_logits(qparams, cfg, inputs, targets), base_ce, base_lg)
    set_w8a8(True)
    try:
        report("w8a8", *ce_and_logits(qparams, cfg, inputs, targets),
               base_ce, base_lg)
    finally:
        set_w8a8(False)
    del qparams

    # The int8 cache differs only where decode reads it back: greedy token
    # agreement over a decode run.
    ref, kv = kv_decodes(params, cfg, toks, decode_steps)
    lines.append({
        "variant": "int8_kv",
        "config": config,
        "dtype": dtype,
        **agreement(ref, kv, "kv_agree"),
        "decode_steps": decode_steps,
    })
    return lines


def kv_decodes(params, cfg, toks, decode_steps: int, attn_fn=None):
    """Greedy ``generate`` from the first :func:`kv_prompt_len` tokens of
    each row of ``toks``, over the model dtype's cache and over an int8 cache:
    ``(tokens, tokens)``, numpy ``[B, decode_steps]`` each. ``attn_fn``
    goes to ``generate`` (None: the kernels on the card)."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import generate

    prompt = toks[:, : kv_prompt_len(toks.shape[1])]
    max_len = prompt.shape[1] + decode_steps
    with torch.no_grad():
        return tuple(
            generate(params, prompt, cfg, decode_steps, max_len=max_len,
                     attn_fn=attn_fn, kv_quantized=q,
                     device=toks.device).cpu().numpy()
            for q in (False, True))


def kv_prompt_len(width: int) -> int:
    """The int8-KV rung's prompt length on tokens ``width`` wide."""
    return min(32, width - 1)


def agreement(a: np.ndarray, b: np.ndarray, key: str) -> dict:
    """Two greedy runs' token agreement under ``key`` and the first step at
    which any row parts (the run's length when none does)."""
    agree = a == b
    first_div = [int(np.argmin(r)) if not r.all() else a.shape[1] for r in agree]
    return {key: round(float(agree.mean()), 6),
            "first_divergence_step": min(first_div)}


def setup(args, device):
    """``(cfg, params, tokens)`` of a run with ``args`` (:func:`parse_args`)
    on ``device``: random weights from ``--seed``, ``[batch, seq_len + 1]``
    tokens drawn by numpy from ``--seed + 1``."""
    import torch

    from kata_xpu_device_plugin_tpu_torch import models

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cfg = getattr(models, args.config)(dtype=dtype)
    params = models.init_params(cfg, seed=args.seed, device=device, dtype=dtype)
    tokens = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, (args.batch, args.seq_len + 1))
    return cfg, params, tokens


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="llama3_train_test",
                    help="models.<name>() config factory (e.g. "
                    "llama3_train_test, llama3_train_bench, gemma_2b_bench)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--decode-steps", type=int, default=64,
                    help="greedy steps for the int8-KV agreement metric")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import torch

    from kata_xpu_device_plugin_tpu_torch import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    cfg, params, tokens = setup(args, device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[torch_eval_quality] {args.config} dtype={args.dtype} "
          f"B={args.batch} S={args.seq_len} on {name}", file=sys.stderr)
    for line in ladder(params, cfg, tokens, args.decode_steps, args.config,
                       args.dtype):
        print(json.dumps(line), flush=True)
    print("[torch_eval_quality] done: delta_ce and top1_agree decide int8 and "
          "W8A8 for this model, kv_agree the int8 cache", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
