#!/usr/bin/env python3
"""Where a decode-attention call's time goes on the card, for the two
decode kernels of ``kata_xpu_device_plugin_tpu_torch`` at Gemma-2B heads
(H=8, KV=1, D=256) and for ``scaled_dot_product_attention`` beside the dense
kernel. What ``chip_smoke.py`` does not measure: the host time of a call and
the profiler's device time per kernel, and the kernels of another checkout.

For each case it prints one JSON line: ``eager_ms`` and ``graph_ms``
(``chip_smoke.time_ms`` and ``chip_smoke.graph_ms``: back-to-back calls,
which time the host when the wrapper's Python is slower than the card, and
the same calls replayed from one CUDA graph, which time the card),
``host_us`` (host time a call, no sync) and ``prof_us`` (``torch.profiler``
device time a call, per kernel name). The inputs are ``chip_smoke``'s.

    python3 scripts/torch_decode_timing.py [CHECKOUT]

``CHECKOUT`` is the root of another checkout whose kernels to time (an
older commit unpacked with ``git archive``); the default is this one. Run
the two in turns in one process on one card to compare them. Needs a CUDA
card; builds the kernels with nvcc at first use.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = (os.path.abspath(sys.argv[1]) if __name__ == "__main__" and len(sys.argv) > 1
        else HERE)
sys.path.insert(0, ROOT)

# This checkout's chip_smoke (its helpers and inputs), whichever package
# ROOT holds.
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               os.path.join(HERE, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

from kata_xpu_device_plugin_tpu_torch.ops import decode_attn as da  # noqa: E402

ITERS = 20


def host_us(fn, iters=200):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def prof_us(fn, iters=ITERS):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            t = getattr(ev, "device_time_total", None) or ev.cuda_time_total
            out[ev.key[:60]] = round(t / iters, 3)
    return out


def paged(B, bs, max_len=2048, full=False, dead=False):
    q, k, v, tables, pos, kw = cs.paged_inputs(B, 8, 1, 256, bs, True, max_len,
                                               dead, full)
    return lambda: da.paged_decode_attention(q, k, v, tables, pos, **kw)


def dense(B, S, pos):
    """The dense kernel and SDPA over ``k[:, :pos+1]`` on the same inputs."""
    q, k, v, p = cs.dense_inputs(B, S, 8, 1, 256, pos)
    return lambda: da.decode_attention(q, k, v, p), cs.sdpa_call(q, k, v, pos)


def cases() -> dict:
    d8, s8 = dense(8, 2048, 2047)
    d32, s32 = dense(32, 4096, 4095)
    return {
        "paged int8 bs128 B8": paged(8, 128),
        "paged int8 bs16 B8 dead": paged(8, 16, dead=True),
        "paged int8 bs128 B8 dead": paged(8, 128, dead=True),
        "paged int8 bs16 B64 full4096": paged(64, 16, max_len=4096, full=True),
        "dense B8 S2048": d8, "sdpa B8 S2048": s8,
        "dense B32 S4096": d32, "sdpa B32 S4096": s32,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_decode_timing: no CUDA device", file=sys.stderr)
        return 1
    for name, fn in cases().items():
        print(json.dumps({"case": name, "eager_ms": cs.time_ms(fn, ITERS, 3),
                          "graph_ms": cs.graph_ms(fn, ITERS),
                          "host_us": host_us(fn), "prof_us": prof_us(fn)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
