#!/usr/bin/env python3
"""Steps per replay of a persistent round's CUDA graph, measured on one card.

A persistent round (``guest.decode_graph.PersistentRound``) replays a graph
of ``sub_steps`` decode steps back to back and reads the round's exit flag
on the host after each replay. Fewer steps a replay cost the card a host
round trip more often; more steps run up to ``sub_steps - 1`` no-op steps
past each exit. This script measures both sides at full Gemma-2B width
(random bf16 weights, seed 0), for each ``sub_steps`` given:

- ``round``: a loaded slotted server (8 lanes, budgets past the cap) runs
  one persistent round to its cap; the round's wall time against the
  device time of the same replays back to back between two CUDA events
  gives the host's gap per replay;
- ``serve``: the paged phase of ``chip_smoke.py`` (32 requests, pool of
  8000 tokens, block 16) through a persistent server: tok/s, ITL, rounds,
  steps delivered and steps run past exits; beside it the lock-step and
  the default (overlapped) server on the same requests.

Servers run in turns, ``--repeats`` times. Run from the repository root:

    python3 scripts/torch_persistent_timing.py [--sub-steps 1,2,4,8] [--repeats 2]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(what: str, **fields) -> None:
    print(json.dumps({"timing": what, **fields}), flush=True)


def round_gap(params, cfg, sub_steps: int, seed: int = 0) -> dict:
    import numpy as np
    import torch

    import chip_smoke
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    srv = GenerationServer(params, cfg, persistent=True, max_batch=8,
                           **chip_smoke.SERVE_KW)
    srv._round.sub_steps = sub_steps
    rng = np.random.default_rng(seed)
    for n in rng.integers(300, 601, 8):
        srv.submit(rng.integers(0, cfg.vocab_size, n), 1200)
    srv._admit()
    srv._ensure_blocks()
    rnd = srv._round

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to("cuda")

    args = (dev(srv._last), dev(srv._pos), dev(srv._decode_budget()),
            dev(srv._persistent_window()))
    rnd(args[0], args[1], dev([2] * 8), args[3])  # the eager warm-up, 2 steps
    rnd(*args)  # the capture, then a round of replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _out, _tok, _pos, delivered = rnd(*args)
    round_s = time.perf_counter() - t0
    replays = rnd.executed // sub_steps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(replays):
        rnd._graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(end) / 1e3
    return dict(sub_steps=sub_steps, lanes=8, delivered=delivered,
                executed=rnd.executed, replays=replays,
                round_s=round(round_s, 6), device_s=round(device_s, 6),
                step_ms=round(1e3 * device_s / rnd.executed, 5),
                host_gap_us_per_replay=round(1e6 * (round_s - device_s) / replays, 2),
                gap_share=round((round_s - device_s) / round_s, 5))


def serve(params, cfg, name: str, extra: dict, sub_steps: int = 0) -> dict:
    import chip_smoke
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    prompts, budgets, lens = chip_smoke.phase_requests(32, cfg.vocab_size)
    srv = GenerationServer(params, cfg, **chip_smoke.PAGED_KW,
                           **chip_smoke.SERVE_KW, **extra)
    if sub_steps:
        srv._round.sub_steps = sub_steps
        outs, wall, _l, st = chip_smoke.run_persistent(srv, prompts, budgets)
    else:
        outs, wall, _l, st = chip_smoke.run_requests(srv, prompts, budgets)
    row = dict(server=name, sub_steps=sub_steps or None,
               tok_s=round(int(sum(budgets)) / wall, 2), wall_s=round(wall, 4),
               itl_p50_s=st["decode_token_s"]["p50"],
               itl_p99_s=st["decode_token_s"]["p99"],
               ttft_p50_s=st["ttft_s"]["p50"], rounds=st["rounds"],
               preemptions=st["preemptions"])
    if sub_steps:
        row.update(delivered=st["delivered_steps_total"],
                   executed=st["persistent_steps_executed"],
                   steps_past_exit=st["steps_past_exit"],
                   exits=st["persistent_exits"])
    return row, outs


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sub-steps", default="1,2,4,8")
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("torch_persistent_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_device()
    params, cfg = chip_smoke.gemma_setup()
    subs = [int(x) for x in args.sub_steps.split(",")]
    for rep in range(args.repeats):
        for m in subs:
            emit("round", repeat=rep, **round_gap(params, cfg, m))
        base = None
        for name, extra, m in ([("lockstep", dict(overlap=False), 0),
                                ("default", {}, 0)]
                               + [(f"persistent_{m}", dict(persistent=True), m)
                                  for m in subs]):
            row, outs = serve(params, cfg, name, extra, m)
            if base is None:
                base = outs
            row["tokens_equal_lockstep"] = all(
                (a == b).all() for a, b in zip(outs, base))
            emit("serve", repeat=rep, **row)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
