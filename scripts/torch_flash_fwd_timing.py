#!/usr/bin/env python3
"""Device time of the flash forward kernel of
``kata_xpu_device_plugin_tpu_torch`` at the Gemma-2B prefill shape and the
two training shapes (with the logsumexp), beside PyTorch's
``scaled_dot_product_attention`` on the same inputs. What ``chip_smoke.py``
does not measure: the kernel of another checkout, in turns with this one's.

For each case it prints one JSON line: ``fwd_ms`` (the kernel by CUDA-graph
replay, ``chip_smoke.graph_ms``, so the wrapper's host time is not read),
``call_ms`` (eager back-to-back calls, ``chip_smoke.time_ms``),
``sdpa_ms`` (SDPA's forward by graph replay, causal, GQA) and the bound
(``chip_smoke.flash_fwd_bound``: operations over the bf16 peak, bytes
over the memory rate, the larger).
q, k and v are slices of one fused projection, the layout the serving
path hands the kernel; inputs are made on the card from a fixed seed.

    python3 scripts/torch_flash_fwd_timing.py [CHECKOUT ...]

Each ``CHECKOUT`` is the root of a checkout whose kernel to time (an older
commit unpacked with ``git archive``); the default is this one. With
several, the cases run for each in the order given, in one process on one
card: give ``new old old new`` to compare two in turns. Needs a CUDA card;
builds the kernels with nvcc at first use.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bwd_timing = _module("torch_flash_bwd_timing",
                     os.path.join(HERE, "scripts", "torch_flash_bwd_timing.py"))
cs = bwd_timing.cs
load_flash = bwd_timing.load_flash

CASES = [  # (name, B, S, H, KV, D, return_lse)
    ("gemma-2b prefill", 4, 1024, 8, 1, 256, False),
    ("llama3-8b train", 2, 2048, 32, 8, 128, True),
    ("gemma-2b train", 2, 2048, 8, 1, 256, True),
]


def fused_qkv(B, S, H, KV, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, S, (H + 2 * KV) * D, generator=g, device="cuda",
                      dtype=torch.bfloat16)
    return (qkv[..., : H * D].reshape(B, S, H, D),
            qkv[..., H * D: (H + KV) * D].reshape(B, S, KV, D),
            qkv[..., (H + KV) * D:].reshape(B, S, KV, D))


def run(flash, root: str, case) -> dict:
    name, B, S, H, KV, D, lse = case
    row = {"checkout": root, "case": name, "B": B, "S": S, "H": H, "KV": KV,
           "D": D, "return_lse": lse}
    q, k, v = fused_qkv(B, S, H, KV, D, B * S + H + D)
    call = lambda: flash.flash_forward(q, k, v, return_lse=lse)  # noqa: E731
    row["fwd_ms"] = cs.graph_ms(call, 20)
    row["call_ms"] = cs.time_ms(call, 20)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row["sdpa_ms"] = cs.graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    return {**row, **cs.flash_fwd_bound(B, S, H, KV, D, True, lse)}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_flash_fwd_timing: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    for root in [os.path.abspath(a) for a in argv] or [HERE]:
        flash = load_flash(root)
        for case in CASES:
            print(json.dumps({**run(flash, root, case), "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
