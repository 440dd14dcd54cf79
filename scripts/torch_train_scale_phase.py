"""Run the training-at-scale phases of a checkout's ``chip_smoke.py``
alone on the card (PERF.md configurations 17-20 and 30): the kernel
build, then ``fsdp_tp``, ``procmesh`` (the same step over a process mesh
of four ranks; it needs ``fsdp_tp``'s losses and bound, so it runs
``fsdp_tp`` first), ``pipeline``, ``ep_moe``, ``lora_mesh`` and
``local_blocks`` (all by default), each line as ``chip_smoke.py`` prints
it, then their launches and seconds.

    python scripts/torch_train_scale_phase.py
        [--phases fsdp_tp,procmesh,pipeline,ep_moe,lora_mesh,local_blocks]
        [--profile] [ROOT]

``ROOT`` is the checkout whose ``chip_smoke.py`` and port package run
(default: this one). It needs a CUDA device and exits non-zero without
one, or when a phase fails. ``--profile`` adds a profiled step to
``fsdp_tp``."""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

PHASES = ("fsdp_tp", "procmesh", "pipeline", "ep_moe", "lora_mesh",
          "local_blocks")


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
    if "procmesh" in phases and "fsdp_tp" not in phases:
        phases.append("fsdp_tp")
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("torch_train_scale_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smoke.phase_device()
    smoke.phase_build()
    out = {}
    ref = {}
    for name in PHASES:
        if name not in phases:
            continue
        t0 = time.perf_counter()
        fn = getattr(smoke, f"phase_{name}")
        if name == "fsdp_tp":
            got = fn(profile=args.profile, keep=ref)
        elif name == "procmesh":
            got = fn(ref, smi)[0]
        else:
            got = fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if name == "local_blocks":
            got = {k: len(v) for k, v in got.items()}
        out[name] = {"launches": got, "seconds": time.perf_counter() - t0}
    print(json.dumps({"phase": "train_scale_seconds", "root": root, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
