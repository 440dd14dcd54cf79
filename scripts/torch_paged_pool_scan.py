#!/usr/bin/env python3
"""Replay the schedule of chip_smoke.py's paged phase on the CPU and print,
for a range of pool sizes, how often the server preempts and how many lanes
decode at once.

The paged scheduler's decisions (admission, growth, preemption) depend only
on prompt lengths and budgets, never on token values (no eos is set), so a
tiny model on the CPU walks exactly the rounds the full-width model walks on
the card. This is how the phase's ``kv_pool_tokens`` was chosen: the largest
size at or under 8192 that presses the pool into preempting.

    python3 scripts/torch_paged_pool_scan.py [LOW HIGH STEP]

Counts only; nothing here is a device measurement.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models import init_params  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models.transformer import (  # noqa: E402
    tiny_test_config,
)


def main(argv: list[str]) -> int:
    low, high, step = (int(a) for a in argv) if argv else (7168, 8192, 16)
    cfg = tiny_test_config(dtype=torch.float32, n_layers=1, vocab_size=512,
                           d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
                           d_ff=16)
    params = init_params(cfg, seed=0, device="cpu")
    for pool in range(low, high + 1, step):
        rng = np.random.default_rng(0)  # chip_smoke.py phase_paged's draws
        lens = rng.integers(64, 1001, 32)
        budgets = rng.integers(64, 129, 32)
        srv = GenerationServer(
            params, cfg, max_batch=16, max_len=2048,
            prefill_buckets=(128, 256, 512, 1024), chunk=8, kv_quant=True,
            kv_pool_tokens=pool, kv_block_size=16, device="cpu")
        for n, b in zip(lens, budgets):
            srv.submit(rng.integers(0, cfg.vocab_size, n), int(b))
        srv.run()
        st = srv.stats()
        print(f"kv_pool_tokens={pool} preemptions={st['preemptions']} "
              f"lanes_busy_peak={st['lanes_busy_peak']} "
              f"occupancy_peak={st['kv_pool_occupancy_peak']} "
              f"rounds={st['rounds']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
