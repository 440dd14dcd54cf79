"""Run the ``guards`` phase of this checkout's ``chip_smoke.py`` alone on
the card: the kernel build, the Gemma-2B setup, then the phase
(``python -m tools.torchguard`` and 20 iterations of
``tests/torch_race_harness.py`` in processes of their own, beside one
``strict=True`` server of each serving form draining 16 requests twice),
each line as ``chip_smoke.py`` prints it, then the phase's seconds.

    python scripts/torch_guards_phase.py

It needs a CUDA device and exits non-zero without one, or when the phase
fails. The phase's artifacts (the analyzer's report, the harness's log
and last iteration, the event stream) are under ``build/guards/``, and
are copied to ``chiprun_out/guards/`` where that directory exists."""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import time


def main() -> int:
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("torch_guards_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smoke.phase_device()
    smoke.phase_build()
    params, cfg = smoke.gemma_setup()
    t0 = time.perf_counter()
    try:
        smoke.phase_guards(params, cfg, smi)
    finally:
        torch.cuda.synchronize()
        out = os.path.join(root, "chiprun_out")
        if os.path.isdir(out):
            shutil.copytree(smoke.GUARDS_DIR, os.path.join(out, "guards"),
                            dirs_exist_ok=True)
    print(json.dumps({"phase": "guards_phase_seconds",
                      "guards": round(time.perf_counter() - t0, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
