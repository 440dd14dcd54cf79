#!/usr/bin/env python3
"""Wall time of building the CUDA kernels of
``kata_xpu_device_plugin_tpu_torch`` from nothing: every ``csrc/*.cu`` of a
checkout compiled by its own ``ops._build.build`` (one nvcc a source, all
started together) into an empty directory.

    python3 scripts/torch_build_timing.py [CHECKOUT ...]

Each ``CHECKOUT`` is the root of a checkout (an older commit unpacked with
``git archive``); the default is this one. Each build runs in a fresh
Python process of its own, so nothing is shared between checkouts; give
``new old old new`` to compare two in turns. Prints one JSON line per
build: the checkout, its sources and the seconds. Needs nvcc (the CUDA
toolkit), not a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from kata_xpu_device_plugin_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[2])
t0 = time.perf_counter()
_build.build(_build.sources())
print(json.dumps({"sources": _build.sources(),
                  "seconds": round(time.perf_counter() - t0, 3)}))
"""


def time_build(root: str) -> dict:
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as out:
        res = subprocess.run([sys.executable, "-c", _CHILD, root, out],
                             capture_output=True, text=True, check=True)
    return {"checkout": os.path.relpath(root, HERE) or ".",
            **json.loads(res.stdout.strip().splitlines()[-1])}


def main(argv: list[str]) -> int:
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    for root in argv or [HERE]:
        print(json.dumps(time_build(os.path.abspath(root))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
