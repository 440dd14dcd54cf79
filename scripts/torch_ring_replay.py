"""Replay configuration 13 (c)'s servers on the card: serve ``gemma2_2b``
(or the model named) over the full arena and with ``ring_kv=True`` as
``chip_smoke.py``'s ``spec`` phase does (4 prompts of 4200-6000 tokens,
budgets 32, int8 KV, seed 0), then, for each request, replay the full
server's tokens with the plain path (a plain prefill of the prompt, then
one plain decode step a token) over the full arena and over its ring
fold, side by side. Prints a JSON line a request: where the two servers
first part, how often the replay's argmax is the full server's own token
(how far an equally valid bf16 path follows the server), the largest
ring-against-full step difference over the logit RMS, and at the parting
each replay's gap between the two servers' tokens.

    python scripts/torch_ring_replay.py [MODEL] [LAYERS]

Needs a CUDA device; exits non-zero without one."""
from __future__ import annotations

import importlib.util
import json
import os
import sys


def main(argv: list[str]) -> int:
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ring_replay: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.phase_device()
    smoke.phase_build()
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models import (
        fuse_decoder_params,
        init_params,
    )
    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        fold_prefill,
        forward,
        prefill,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.attention import (
        reference_attention,
    )

    name = argv[0] if argv else "gemma2_2b"
    cfg, reduced = smoke.family_config(name, int(argv[1]) if len(argv) > 1
                                       else None)
    params = fuse_decoder_params(
        init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(4200, 6001, 4)]
    max_len = 8192
    kw = dict(max_batch=4, max_len=max_len, chunk=8, prefill_buckets=tuple(
        b for b in smoke.LONG_BUCKETS if b <= max_len))
    outs = {}
    for run, extra in (("full", {}), ("ring", dict(ring_kv=True))):
        srv = GenerationServer(params, cfg, **kw, **extra)
        rids = [srv.submit(p, 32) for p in prompts]
        res = srv.run()
        outs[run] = [np.asarray(res[r]) for r in rids]
        del srv
        torch.cuda.empty_cache()
    for r, prompt in enumerate(prompts):
        a, b = outs["ring"][r], outs["full"][r]
        diff = np.flatnonzero(a != b)
        j = int(diff[0]) if len(diff) else None
        toks = torch.from_numpy(prompt.astype(np.int64))[None].cuda()
        arenas = {}
        for arena in ("full", "ring"):
            caches, _l, pos = prefill(params, toks, cfg, max_len,
                                      attn_fn=reference_attention,
                                      kv_quantized=True)
            arenas[arena] = (fold_prefill(caches, pos, cfg, max_len)
                             if arena == "ring" else caches)
        follows, worst, last = 0, 0.0, None
        steps = (j if j is not None else len(b)) - 1
        for t in range(steps + (j is not None)):
            at = torch.full((1,), len(prompt) + t, dtype=torch.int32,
                            device="cuda")
            tok = torch.full((1, 1), int(b[t]), device="cuda")
            lg = {arena: forward(params, tok, cfg, attn_fn=reference_attention,
                                 positions=at[:, None], kv_caches=caches,
                                 cache_offset=at, ring=arena == "ring"
                                 )[0][0, -1].float()
                  for arena, caches in arenas.items()}
            rms = float(lg["full"].square().mean().sqrt())
            worst = max(worst, float((lg["ring"] - lg["full"]).abs().max()) / rms)
            if t + 1 < len(b) and t + 1 != j:
                follows += int(lg["full"].argmax()) == int(b[t + 1])
            if t + 1 == j:
                last = {arena: round(float(x[int(b[j])] - x[int(a[j])]), 5)
                        for arena, x in lg.items()}
                last["logit_rms"] = round(rms, 5)
        print(json.dumps({
            "model": name, "reduced": reduced, "request": r,
            "prompt_len": len(prompt), "parting": j,
            "replay_follows_full_server": [follows, steps],
            "max_step_diff_ring_vs_full_x_rms": round(worst, 5),
            "gap_at_parting": last}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
