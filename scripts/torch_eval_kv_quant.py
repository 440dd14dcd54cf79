"""The int8-KV quality gate of the PyTorch port (counterpart of
``tools/eval_quality.py`` ``evaluate_kv_quant`` and ``gate``).

``GenerationServer`` serves an int8 KV cache by default. This is the gate
behind that default: on a fixed prompt set, greedy decoding over an int8
cache against the same decoding over a cache of the model's dtype, and the
max-abs logit drift of the first decode step (prefill attends the fresh
k/v, so the first decode step is the first read across the quantized
cache). The gate passes when the pooled token agreement is at least 0.7
and the drift at most 0.5, the JAX package's thresholds.

    python scripts/torch_eval_kv_quant.py [--cpu] [--model NAME]
        [--prompts 4] [--steps 12] [--seed 0]

prints one JSON line with the evidence and ``"gate": "pass"|"fail"`` and
exits non-zero on a fail. ``--model`` names a config of the port's
``models`` (default ``tiny_test_config``, fp32; others in their own dtype,
random weights from ``--seed``). With
``--cpu`` it runs the plain path on the CPU; without it, on the card,
through the flash and paged decode kernels, its prompts at flash lengths
(a head_dim the kernels take: e.g. ``--model gemma_2b``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

# The JAX package's gate thresholds (tools/eval_quality.py): int8 KV
# carries ~0.4% relative error a cache read, so greedy streams agree but
# can part late; the floors sit below the tiny model's measured band.
DEFAULT_MIN_GREEDY_MATCH = 0.7
DEFAULT_MAX_LOGIT_ERR = 0.5


def evaluate_kv_quant(params, cfg, prompts, steps: int = 12, max_len: int = 0,
                      attn_fn=None, decode_kernel_fn=None) -> dict:
    """Int8-KV decoding against the model-dtype cache on ``prompts`` (1-D
    integer arrays), on the params' device. Returns per-prompt greedy
    agreement and first-decode-step logit drift and the aggregates
    :func:`gate` reads. ``attn_fn`` is the prefill's attention (default:
    the flash path); with ``decode_kernel_fn`` (``ops.attention.
    make_decode_attn_fn``) decode steps run it at a ``[1]`` position
    (ragged), else every step is lock-step at a scalar position through
    the plain attention, as the JAX function runs."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        _decode_scan,
        forward,
        greedy_token,
        prefill,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention

    device = params["embed"].device
    per_prompt = []
    for prompt in prompts:
        prompt = torch.as_tensor(np.asarray(prompt, np.int64).reshape(1, -1),
                                 device=device)
        S = prompt.shape[1]
        m_len = max_len or S + steps
        caches_bf, logits_bf, pos = prefill(params, prompt, cfg, m_len,
                                            attn_fn=attn_fn, return_logits=True)
        caches_q, _, _ = prefill(params, prompt, cfg, m_len, attn_fn=attn_fn,
                                 return_logits=True, kv_quantized=True)
        tok = greedy_token(logits_bf)
        at = (torch.full((1,), pos, dtype=torch.int32, device=device)
              if decode_kernel_fn is not None else pos)
        rows = at[:, None] if torch.is_tensor(at) else torch.full(
            (1, 1), pos, dtype=torch.int32, device=device)
        dec_attn = None if decode_kernel_fn is not None else reference_attention

        def step(caches):
            logits, _ = forward(params, tok[:, None], cfg, attn_fn=dec_attn,
                                positions=rows, kv_caches=caches,
                                cache_offset=at, decode_kernel_fn=decode_kernel_fn)
            return logits

        logit_err = float((step(caches_q) - step(caches_bf)).abs().max())
        # The step above wrote tok's k/v at pos; decode's first step writes
        # the same values there again.
        out_bf = _decode_scan(params, caches_bf, tok, at, cfg, steps, dec_attn,
                              decode_kernel_fn=decode_kernel_fn).cpu().numpy()
        out_q = _decode_scan(params, caches_q, tok, at, cfg, steps, dec_attn,
                             decode_kernel_fn=decode_kernel_fn).cpu().numpy()
        agree = int((out_bf == out_q).sum())
        per_prompt.append({
            "prompt_len": S,
            "greedy_match": round(agree / out_bf.size, 4),
            "tokens_agree": agree,
            "tokens": int(out_bf.size),
            "logit_max_abs_err": round(logit_err, 6),
        })
    total = sum(p["tokens"] for p in per_prompt)
    return {
        "prompts": len(per_prompt),
        "steps": steps,
        # Pooled over the set: one flipped near-tie derails the rest of its
        # stream by greedy cascade, so it weighs by its tokens.
        "greedy_match": round(sum(p["tokens_agree"] for p in per_prompt) / total, 4),
        "worst_prompt_match": round(min(p["greedy_match"] for p in per_prompt), 4),
        "logit_max_abs_err": round(max(p["logit_max_abs_err"] for p in per_prompt), 6),
        "per_prompt": per_prompt,
    }


def gate(result: dict, min_greedy_match: float = DEFAULT_MIN_GREEDY_MATCH,
         max_logit_err: float = DEFAULT_MAX_LOGIT_ERR) -> bool:
    """The promotion decision: pooled token agreement at or above the floor
    and the worst first-step logit drift at or below the ceiling."""
    return (result["greedy_match"] >= min_greedy_match
            and result["logit_max_abs_err"] <= max_logit_err)


def default_prompts(vocab: int, n: int, seed: int = 0, lengths=None) -> list:
    """``n`` prompts drawn by numpy from ``seed``, of lengths 5, 8, 11, ...
    (the JAX set's lengths) unless ``lengths`` is given."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = lengths or [5 + 3 * i for i in range(n)]
    return [rng.integers(0, vocab, k).astype(np.int32) for k in lengths[:n]]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--model", default="tiny_test_config")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-match", type=float, default=DEFAULT_MIN_GREEDY_MATCH)
    ap.add_argument("--max-logit-err", type=float, default=DEFAULT_MAX_LOGIT_ERR)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.models.transformer import CUDA_PAD

    device = "cpu" if args.cpu else None
    tiny = args.model == "tiny_test_config"
    cfg = getattr(models, args.model)(**({"dtype": torch.float32} if tiny else {}))
    params = models.init_params(cfg, seed=args.seed, device=device,
                                dtype=cfg.dtype)
    kw, lengths = {}, None
    if params["embed"].is_cuda:
        from kata_xpu_device_plugin_tpu_torch.ops.attention import make_decode_attn_fn

        lengths = [CUDA_PAD * (i + 1) for i in range(args.prompts)]
        max_len = -(-(lengths[-1] + args.steps) // CUDA_PAD) * CUDA_PAD
        kw = dict(max_len=max_len, decode_kernel_fn=make_decode_attn_fn(
            cfg, arena_len=max_len, device=params["embed"].device))
    result = evaluate_kv_quant(
        params, cfg, default_prompts(cfg.vocab_size, args.prompts, args.seed,
                                     lengths), steps=args.steps, **kw)
    ok = gate(result, args.min_match, args.max_logit_err)
    result["gate"] = "pass" if ok else "fail"
    result["thresholds"] = {"min_greedy_match": args.min_match,
                            "max_logit_err": args.max_logit_err}
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
