"""Run the serving-over-a-mesh phases of a checkout's ``chip_smoke.py``
alone on the card (PERF.md configurations 21-24): the kernel build, then
``serve_mesh``, ``moe_tp``, ``convert``, ``probe`` and ``mesh_shards``
(the two kernels at the servers' model-shard shapes; all by default),
each line as ``chip_smoke.py`` prints it, then their launches and seconds.

    python scripts/torch_serve_mesh_phase.py
        [--phases serve_mesh,moe_tp,convert,probe,mesh_shards] [--profile]
        [ROOT]

``ROOT`` is the checkout whose ``chip_smoke.py`` and port package run
(default: this one). It needs a CUDA device and exits non-zero without
one, or when a phase fails. ``--profile`` adds a profiled window of the
Gemma-2B mesh server's decode rounds to ``serve_mesh``."""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

PHASES = ("serve_mesh", "moe_tp", "convert", "probe", "mesh_shards")


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
        print("torch_serve_mesh_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.phase_device()
    smoke.phase_build()
    out = {}
    for name in PHASES:
        if name not in phases:
            continue
        t0 = time.perf_counter()
        fn = getattr(smoke, f"phase_{name}")
        got = fn(profile=args.profile) if name == "serve_mesh" else fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if name == "mesh_shards":
            got = {k: len(v) for k, v in got.items()}
        out[name] = {"result": got if name != "convert" else None,
                     "seconds": time.perf_counter() - t0}
    print(json.dumps({"phase": "serve_mesh_seconds", "root": root, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
