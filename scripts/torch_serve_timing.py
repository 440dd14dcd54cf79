#!/usr/bin/env python3
"""Serving times of ``kata_xpu_device_plugin_tpu_torch``'s GenerationServer
at full Gemma-2B width, for each round loop and decode-steps setting, in
turns across checkouts. What ``chip_smoke.py`` does not measure: the
matrix of loops and K, and another checkout's server on the same card.

The workloads are shaped as ``chip_smoke.py``'s serving phases (random
bf16 weights from seed 0, int8 KV, chunk 8, prefill buckets 128-1024,
max_len 2048; requests from seed 0): ``slotted``,
8 lanes and 16 requests; ``paged``, ``max_batch=16, kv_pool_tokens=8000,
kv_block_size=16`` and 32 requests; prompts of 64-1000 tokens, budgets of
64-128, all submitted at once. Each runs with ``overlap`` True and False
and ``decode_steps`` 1 and 4; a checkout whose server raises on a setting
(one from before these loops were ported) runs the settings it takes.
Each server first serves one short request that takes it through its
one-time costs (its eager first chunk, its graph capture). For each run
it prints one JSON line: generated tokens/s (host clock around ``run()``),
TTFT and ITL p50/p99 (``stats()``), rounds,
preemptions, the decode graph's captures, replays, capture seconds and
pool bytes where the server has them. ``--profile`` adds, for each
setting, one ``torch.profiler`` window over at least 48 decode steps of a
loaded server after two warm rounds (``chip_smoke.profiled``; its
``device_idle_share`` is the card's idle share).

    python3 scripts/torch_serve_timing.py [--profile] [--chunked] [CHECKOUT ...]

``--chunked`` runs, in place of that matrix, the paged layout's requests
through ``slo_chunked`` admission (``itl_slo_ms=0``, ``prefill_chunk=128``)
with fused slices and without: the chunked forms of the ``guards`` phase,
without strict mode, so that a checkout whose slices wait for the card
runs them too.

Each ``CHECKOUT`` is the root of a checkout (an older commit unpacked with
``git archive``); the default is this one. With several, each runs its
whole matrix in the order given, in one process on one card: give ``new
old old new`` to compare two in turns. Needs a CUDA card; builds the
kernels with nvcc at first use.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _module("chip_smoke", os.path.join(HERE, "chip_smoke.py"))

LAYOUTS = {
    "slotted": (dict(max_batch=8), 16, 8),  # (server kwargs, requests, profiled lanes)
    "paged": (cs.PAGED_KW, 32, 16),
}
SETTINGS = [dict(overlap=o, decode_steps=k) for o in (True, False) for k in (1, 4)]
CHUNKED = [dict(sched_policy="slo_chunked", itl_slo_ms=0.0, prefill_chunk=128,
                fused=f) for f in (True, False)]


def load_serving(root: str):
    """``guest.serving`` of the checkout at ``root``, as a fresh import."""
    for name in [m for m in sys.modules if m.startswith(cs.PKG)]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        return importlib.import_module(f"{cs.PKG}.guest.serving")
    finally:
        sys.path.remove(root)


def requests(cfg, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1001, n)
    budgets = rng.integers(64, 129, n)
    return [rng.integers(0, cfg.vocab_size, m).astype(np.int32) for m in lens], budgets


def server(serving, params, cfg, kw, setting):
    """A server of ``setting``, or None where the checkout raises on it."""
    try:
        return serving.GenerationServer(params, cfg, **kw, **setting)
    except NotImplementedError:
        return None


def run(srv, prompts, budgets) -> dict:
    """The requests through ``srv``, timed, after one short request that
    takes the server through its one-time costs (its first chunk and, where
    it has one, its graph capture); the latency summaries start afresh
    after that request, and the counters are the timed run's."""
    steps = getattr(srv, "_dispatch_steps", srv.chunk)
    srv.submit(np.arange(1, 101, dtype=np.int32), steps + 2)
    srv.run()
    latency = type(srv._ttft)
    srv._ttft, srv._tok_lat = latency(), latency()
    base = srv.stats()
    rids = [srv.submit(p, int(b)) for p, b in zip(prompts, budgets)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if [len(out[r]) for r in rids] != [int(b) for b in budgets]:
        raise AssertionError("a request did not return its budget")
    st = srv.stats()
    row = dict(wall_s=round(wall, 4), tok_s=round(int(sum(budgets)) / wall, 2),
               ttft_p50_s=st["ttft_s"]["p50"], ttft_p99_s=st["ttft_s"]["p99"],
               itl_p50_s=st["decode_token_s"]["p50"],
               itl_p99_s=st["decode_token_s"]["p99"],
               **{k: st[k] - base[k] for k in (
                   "rounds", "prefill_batches", "preemptions")})
    row.update({k: st[k] for k in st if k.startswith("decode_graph_")})
    return row


def profile(srv, cfg, lanes: int, seed: int = 1, **fields) -> None:
    """Two warm rounds (the warm-up chunk, the capture), then
    ``chip_smoke.window_rounds`` rounds under the profiler."""
    steps = getattr(srv, "_dispatch_steps", srv.chunk)
    n_rounds = cs.window_rounds(steps)
    rng = np.random.default_rng(seed)
    for n in rng.integers(500, 1001, lanes):
        srv.submit(rng.integers(0, cfg.vocab_size, n), (n_rounds + 3) * steps)
    srv.step()
    srv.step()

    def rounds():
        for _ in range(n_rounds):
            srv.step()

    cs.profiled(f"{n_rounds} rounds ({n_rounds * steps} steps), {lanes} "
                "requests, prompts 500-1000", rounds, rounds=n_rounds, **fields)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_serve_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    do_profile = "--profile" in argv
    chunked = "--chunked" in argv
    roots = [os.path.abspath(a) for a in argv
             if a not in ("--profile", "--chunked")] or [HERE]
    layouts = {"paged": LAYOUTS["paged"]} if chunked else LAYOUTS
    settings = CHUNKED if chunked else SETTINGS
    smi = cs.phase_device()
    params = cfg = None
    for root in roots:
        serving = load_serving(root)
        if params is None:
            params, cfg = cs.gemma_setup()
        for layout, (kw, n, lanes) in layouts.items():
            prompts, budgets = requests(cfg, n)
            for setting in settings:
                kwargs = dict(**kw, **cs.SERVE_KW)
                srv = server(serving, params, cfg, kwargs, setting)
                if srv is None:
                    continue
                row = run(srv, prompts, budgets)
                del srv
                print(json.dumps({"checkout": root, "layout": layout, **setting,
                                  **row, "device": smi}), flush=True)
                if do_profile:
                    profile(server(serving, params, cfg, kwargs, setting), cfg,
                            lanes, checkout=root, layout=layout, **setting)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
