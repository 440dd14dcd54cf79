"""Run the ``resilience`` phase of a checkout's ``chip_smoke.py`` alone on
the card: the kernel build, the Gemma-2B setup, then the phase (the
fault-free and faulted runs of the paged config, the quarantine drill, the
tp=4 blocks shrink), each line as ``chip_smoke.py`` prints it, then the
phase's seconds. The phase's event stream is copied to
``chiprun_out/resilience_events.jsonl`` where that directory exists.

    python scripts/torch_resilience_phase.py [ROOT]

``ROOT`` is the checkout whose ``chip_smoke.py`` and port package run
(default: this one). It needs a CUDA device and exits non-zero without
one, or when the phase fails."""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import time


def main(argv: list[str]) -> int:
    root = os.path.abspath(argv[0] if argv else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("torch_resilience_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smoke.phase_device()
    smoke.phase_build()
    params, cfg = smoke.gemma_setup()
    t0 = time.perf_counter()
    launches = smoke.phase_resilience(params, cfg, smi)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "resilience_seconds", "root": root,
                      "launches": launches,
                      "seconds": time.perf_counter() - t0}), flush=True)
    out = os.path.join(root, "chiprun_out")
    if os.path.isdir(out):
        shutil.copy(os.path.join(smoke.RESILIENCE_DIR, "events.jsonl"),
                    os.path.join(out, "resilience_events.jsonl"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
