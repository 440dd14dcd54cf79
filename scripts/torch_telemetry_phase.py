"""Run the ``telemetry`` phase of a checkout's ``chip_smoke.py`` alone on the
card: the kernel build, the Gemma-2B setup, then the phase (the paged
configuration's 32 requests through a server with telemetry off and one
with the defaults and strict mode, in turns twice, and the watchdog,
strict-mode, profiler and ``fit`` drills), each line as ``chip_smoke.py``
prints it, then the phase's seconds. ``--serve`` runs the ``serve`` and
``paged`` phases first (their tok/s with the checkout's default server).

    python scripts/torch_telemetry_phase.py [--serve] [ROOT]

``ROOT`` is the checkout whose ``chip_smoke.py`` and port package run
(default: this one; an unpacked older checkout runs ``--serve`` only, as
it has no telemetry phase). It needs a CUDA device and exits non-zero
without one, or when a phase fails."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time


def main(argv: list[str]) -> int:
    serve = "--serve" in argv
    args = [a for a in argv if a != "--serve"]
    root = os.path.abspath(args[0] if args else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("torch_telemetry_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smoke.phase_device()
    smoke.phase_build()
    params, cfg = smoke.gemma_setup()
    seconds = {}
    phases = [("serve", smoke.phase_serve, ()), ("paged", smoke.phase_paged, ())]
    if not serve:
        phases = []
    if hasattr(smoke, "phase_telemetry"):
        phases.append(("telemetry", smoke.phase_telemetry, (smi,)))
    for name, fn, extra in phases:
        t0 = time.perf_counter()
        fn(params, cfg, *extra)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 2)
    print(json.dumps({"phase": "telemetry_phase_seconds", "root": root,
                      **seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
