#!/usr/bin/env python3
"""Device time of the flash backward kernels of
``kata_xpu_device_plugin_tpu_torch`` at the training shapes, beside the
``delta`` reduction that precedes them and PyTorch's
``scaled_dot_product_attention`` backward on the same inputs. What
``chip_smoke.py`` does not measure: the kernels of another checkout, in
turns with this one's, and the shapes of every head width at once.

For each case it prints one JSON line: ``dq_ms``, ``dkv_ms`` and
``delta_ms`` (CUDA events over back-to-back launches, ``chip_smoke.time_ms``),
their sum ``pair_ms``, ``backward_ms`` (``flash_backward``, whose dq kernel
forms delta itself, where the checkout has that route),
``sdpa_bwd_ms`` (``torch.autograd.grad`` through SDPA, the same inputs),
and each kernel's bound (operations over the bf16 peak, bytes over the
memory rate, the larger). Inputs are made on the card from a fixed seed.

    python3 scripts/torch_flash_bwd_timing.py [CHECKOUT ...]

Each ``CHECKOUT`` is the root of a checkout whose kernels to time (an
older commit unpacked with ``git archive``); the default is this one. With
several, the cases run for each in the order given, in one process on one
card: give ``new old old new`` to compare two in turns. A checkout whose
backward does not take a head width prints ``"skipped"`` for it. Needs a
CUDA card; builds the kernels with nvcc at first use.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               os.path.join(HERE, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

CASES = [  # (name, B, S, H, KV, D)
    ("llama3-8b train", 2, 2048, 32, 8, 128),
    ("gemma-2b train", 2, 2048, 8, 1, 256),
    ("D64", 2, 2048, 16, 4, 64),
]


def load_flash(root: str):
    """``ops.flash`` of the checkout at ``root``, as a fresh import."""
    for name in [m for m in sys.modules if m.startswith(cs.PKG)]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        return importlib.import_module(f"{cs.PKG}.ops.flash")
    finally:
        sys.path.remove(root)


def bounds(B, S, H, KV, D) -> dict:
    pairs = B * H * S * (S + 1) / 2
    in_bytes = 2.0 * B * S * D * (2 * H + 2 * KV) + 8.0 * B * H * S
    out = {}
    for key, products, out_bytes in (("dq", 3, 2.0 * B * S * H * D),
                                     ("dkv", 4, 4.0 * B * S * KV * D)):
        t_ops = products * 2.0 * D * pairs / cs.PEAK_BF16_FLOPS
        t_bytes = (in_bytes + out_bytes) / cs.PEAK_HBM_BYTES
        out[f"{key}_bound_ms"] = 1e3 * max(t_ops, t_bytes)
    return out


def run(flash, root: str, case) -> dict:
    name, B, S, H, KV, D = case
    row = {"checkout": root, "case": name, "B": B, "S": S, "H": H, "KV": KV,
           "D": D}
    if D not in flash.BWD_HEAD_DIMS:
        return {**row, "skipped": f"head_dim {D} not taken"}
    g = torch.Generator(device="cuda").manual_seed(B * S + H + D)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q, k, v, do = rnd(B, S, H, D), rnd(B, S, KV, D), rnd(B, S, KV, D), rnd(B, S, H, D)
    out, lse = flash.flash_forward(q, k, v, return_lse=True)
    delta = flash._delta(out, do)
    row["dq_ms"] = cs.time_ms(lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta), 10)
    row["dkv_ms"] = cs.time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta), 10)
    row["delta_ms"] = cs.time_ms(lambda: flash._delta(out, do), 10)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    do_t = do.transpose(1, 2)
    row["sdpa_bwd_ms"] = cs.time_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), do_t, retain_graph=True), 10)
    row["pair_ms"] = row["dq_ms"] + row["dkv_ms"] + row["delta_ms"]
    if hasattr(flash, "_launch_dq"):  # delta formed by the dq kernel
        row["backward_ms"] = cs.time_ms(
            lambda: flash.flash_backward(q, k, v, out, lse, do), 10)
    return {**row, **bounds(B, S, H, KV, D)}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_flash_bwd_timing: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    for root in [os.path.abspath(a) for a in argv] or [HERE]:
        flash = load_flash(root)
        for case in CASES:
            print(json.dumps({**run(flash, root, case), "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
