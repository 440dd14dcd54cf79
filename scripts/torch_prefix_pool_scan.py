#!/usr/bin/env python3
"""Replay the schedule of chip_smoke.py's prefix phase on the CPU and print,
for a range of pool sizes, what the prefix cache and the host tier do:
hits, the tier's evictions, demotions, promotions, preemptions and
copy-on-write copies, for the server without the host tier and with
``kv_host_tokens=4096``.

Admission, growth, eviction, demotion and preemption depend only on prompt
lengths, budgets and which prompts share a head, never on token values (no
eos is set), so a tiny model on the CPU walks the rounds the full-width
model walks on the card. This is how the phase's pool for its prefix runs
was chosen: the largest size at or under the paged phase's 8000 tokens at
which the host-tier run demotes.

    python3 scripts/torch_prefix_pool_scan.py [LOW HIGH STEP]

Counts only; nothing here is a device measurement.
"""
from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import PREFIX_WAVES, prefix_requests  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models import init_params  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models.transformer import (  # noqa: E402
    tiny_test_config,
)


def serve_waves(params, cfg, pool: int, host: int) -> dict:
    prompts, budgets, _lens, _order = prefix_requests(cfg.vocab_size)
    srv = GenerationServer(
        params, cfg, max_batch=16, max_len=2048,
        prefill_buckets=(128, 256, 512, 1024), chunk=8, kv_quant=True,
        kv_pool_tokens=pool, kv_block_size=16, prefix_cache_tokens=1,
        kv_host_tokens=host or None, device="cpu")
    at = 0
    for n in PREFIX_WAVES:
        for p, b in zip(prompts[at:at + n], budgets[at:at + n]):
            srv.submit(p, int(b))
        srv.run()
        at += n
    st = srv.stats()
    tier = srv.prefix_store.stats()
    return dict(hits=st["prefix_hits"], evictions=tier["evictions"],
                demotions=st["kv_demotions"], prefetches=st["kv_prefetches"],
                preemptions=st["preemptions"], cow=st["cow_copies"],
                lanes=st["lanes_busy_peak"], rounds=st["rounds"])


def main(argv: list[str]) -> int:
    low, high, step = (int(a) for a in argv) if argv else (6000, 8000, 250)
    cfg = tiny_test_config(dtype=torch.float32, n_layers=1, vocab_size=512,
                           d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
                           d_ff=16)
    params = init_params(cfg, seed=0, device="cpu")
    for pool in range(high, low - 1, -step):
        rows = {h: serve_waves(params, cfg, pool, h) for h in (0, 4096)}
        print(f"kv_pool_tokens={pool} no_host={rows[0]} host_4096={rows[4096]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
