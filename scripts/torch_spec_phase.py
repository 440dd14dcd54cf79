"""Run the ``spec`` phase of a checkout's ``chip_smoke.py`` alone on the
card: the kernel build, the Gemma-2B setup, then the phase (configuration
13: n-gram and draft-model speculation on Gemma-2B beside the plain
lock-step server, ``generate_speculative``, then ``ring_kv`` serving of
Gemma-2-2B and Mistral-7B beside the full arena, with and without
speculation, and the ring entry points), each line as ``chip_smoke.py``
prints it, then the phase's launches and seconds.

    python scripts/torch_spec_phase.py [ROOT]

``ROOT`` is the checkout whose ``chip_smoke.py`` and port package run
(default: this one). It needs a CUDA device and exits non-zero without
one, or when the phase fails."""
from __future__ import annotations

import importlib.util
import json
import os
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
        print("torch_spec_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.phase_device()
    smoke.phase_build()
    params, cfg = smoke.gemma_setup()
    t0 = time.perf_counter()
    launches = smoke.phase_spec(params, cfg)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "spec_seconds", "root": root,
                      "launches": launches,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
