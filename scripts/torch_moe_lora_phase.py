"""Run the ``w8a8``, ``kv_gate``, ``lora`` and ``moe`` phases of a
checkout's ``chip_smoke.py`` alone on the card (PERF.md configurations
14-16): the kernel build, the Gemma-2B setup, then the phases named (all
four by default), each line as ``chip_smoke.py`` prints it, then their
launches and seconds.

    python scripts/torch_moe_lora_phase.py [--phases w8a8,kv_gate,lora,moe]
        [--profile] [ROOT]

``ROOT`` is the checkout whose ``chip_smoke.py`` and port package run
(default: this one). It needs a CUDA device and exits non-zero without
one, or when a phase fails. ``--profile`` adds the moe phase's profiled
decode windows."""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

PHASES = ("w8a8", "kv_gate", "lora", "moe")


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("root", nargs="?",
                    default=os.path.join(os.path.dirname(__file__), ".."))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("torch_moe_lora_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.phase_device()
    smoke.phase_build()
    params = cfg = None
    if {"w8a8", "kv_gate"} & set(phases):
        params, cfg = smoke.gemma_setup()
    out = {}
    for name in PHASES:
        if name not in phases:
            continue
        if name in ("lora", "moe") and params is not None:
            params = None
            torch.cuda.empty_cache()
        fn = getattr(smoke, f"phase_{name}")
        t0 = time.perf_counter()
        if name in ("w8a8", "kv_gate"):
            launches = fn(params, cfg)
        else:
            launches = fn(profile=args.profile) if name == "moe" else fn()
        torch.cuda.synchronize()
        out[name] = {"launches": launches, "seconds": time.perf_counter() - t0}
    print(json.dumps({"phase": "moe_lora_seconds", "root": root, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
