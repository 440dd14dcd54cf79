"""Run the ``seq`` phases of a checkout's ``chip_smoke.py`` alone on the
card: the kernel build, then sequence-parallel training (``seq``: Llama-3-8B
widths, 8 layers, S=8192 over a ring of 4, 4 steps), its crosscheck
(``seq_crosscheck``) and the Gemma-2-2B side run (``seq_gemma2``), each
line as ``chip_smoke.py`` prints it, then the phases' seconds.

    python scripts/torch_seq_phase.py [--checks] [--profile] [ROOT]

``--checks`` first runs the K1 block cases of the check phase (the
``flash_block`` lines and their timings); ``--profile`` adds one more
step of each training run under ``torch.profiler`` (the ``profile``
lines: device time by class and by kernel, the idle share). ``ROOT`` is the checkout whose
``chip_smoke.py`` and port package run (default: this one), so an unpacked
older tree can be timed beside this one in one session on one card. It
needs a CUDA device and exits non-zero without one, or when a phase
fails."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time


def main(argv: list[str]) -> int:
    checks, profile = "--checks" in argv, "--profile" in argv
    args = [a for a in argv if a not in ("--checks", "--profile")]
    root = os.path.abspath(args[0] if args else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("torch_seq_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.phase_device()
    smoke.phase_build()
    seconds = {}
    if checks:
        t0 = time.perf_counter()
        for case in (("llama3-8b full pair", 2048, 32, 8, 128, 6144, 0),
                     ("llama3-8b diagonal pair", 2048, 32, 8, 128, 4096, 4096)):
            smoke.block_case(*case, timed=True)
        smoke.block_case("gemma2-2b window4096 softcap50 pair", 2048, 8, 4, 256,
                         4096, 0, window=4096, softcap=50.0, timed=True)
        seconds["block_checks"] = time.perf_counter() - t0
    for name, fn, kw in (
            ("seq", smoke.phase_seq, dict(profile=profile)),
            ("seq_crosscheck", smoke.seq_crosscheck, {}),
            ("seq_gemma2", smoke.phase_seq,
             dict(model="gemma2_2b", n_layers=4, steps=3, profile=profile,
                  phase="seq_gemma2"))):
        t0 = time.perf_counter()
        fn(**kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
    print(json.dumps({"phase": "seq_seconds", "root": root, **seconds}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
