"""Run the host phase of a checkout's ``chip_smoke.py`` alone on the card
(PERF.md configuration 25): the kernel build, then ``host``: the GPU
daemon's discovery over the machine's real /sys, /dev and /proc, its CDI
spec, an Allocate with the serving knobs, and Gemma-2B served on the card
by a guest process started with exactly that allocation's env. Each line
as ``chip_smoke.py`` prints it, then the guest's launches and the seconds.

    python scripts/torch_host_phase.py [ROOT]

``ROOT`` is the checkout whose ``chip_smoke.py`` and port package run
(default: this one). It needs a CUDA device and exits non-zero without
one, or when the phase fails."""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=os.path.join(os.path.dirname(__file__), ".."))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("torch_host_phase: no CUDA device", file=sys.stderr)
        return 1
    smi = smoke.phase_device()
    smoke.phase_build()
    t0 = time.perf_counter()
    launches = smoke.phase_host(smi)
    print(json.dumps({"phase": "host_seconds", "root": root, "launches": launches,
                      "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
