"""Run the daemon and bench-config phases of a checkout's ``chip_smoke.py``
alone on the card (PERF.md configurations 25, 26 and 27), after the kernel
build:

- ``host``: the GPU daemon's discovery over the machine's real /sys, /dev
  and /proc, its CDI spec, an Allocate with the serving knobs, and Gemma-2B
  served on the card by a guest process started with exactly that
  allocation's env;
- ``multihost``: two GPU daemons on this machine as workers 0 and 1 of one
  two-host membership (flags; a metadata dir), their JSON specs, an
  Allocate each, ``status --json`` with the stand-in kubelets'
  pod-resources, worker 1 restarted through a metadata outage, two guests
  with their allocations' env rendezvousing over gloo and striding one
  global batch, and worker 0's guest serving ``gemma_2b_bench`` on the card;
- ``bench_configs``: ``fit`` of ``llama3_train_bench`` (12 layers, B=16,
  S=1024, remat), its flash kernels at head_dim 64 against their plain
  versions and timed, the paged decode kernel at its heads against its
  plain version, and ``scripts/torch_eval_quality.py --config
  llama3_train_bench --dtype bfloat16`` with a plain-attention witness for
  its int8-KV rung.

Each line as ``chip_smoke.py`` prints it, then the launches and seconds.

    python scripts/torch_multihost_phase.py [--phases host,multihost,bench_configs] [ROOT]

``ROOT`` is the checkout whose ``chip_smoke.py`` and port package run
(default: this one). It needs a CUDA device and exits non-zero without
one, or when a phase fails."""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

PHASES = ("host", "multihost", "bench_configs")


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("root", nargs="?",
                    default=os.path.join(os.path.dirname(__file__), ".."))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if not set(phases) <= set(PHASES):
        ap.error(f"phases are {PHASES}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("torch_multihost_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smoke.phase_device()
    smoke.phase_build()
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "host":
            launches = smoke.phase_host(smi)
        elif phase == "multihost":
            launches = smoke.phase_multihost(smi)
        else:
            launches, _ = smoke.phase_bench_configs()
        torch.cuda.synchronize()
        print(json.dumps({"phase": f"{phase}_seconds", "root": root,
                          "launches": launches,
                          "seconds": round(time.perf_counter() - t0, 2)}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
