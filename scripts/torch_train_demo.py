#!/usr/bin/env python3
"""The guest's end-to-end journey on the PyTorch port (counterpart of
``scripts/train_demo.py``): synthesize a corpus, train over a data x fsdp
x model mesh with checkpoints, get "preempted" and resume, LoRA fine-tune
the frozen base, merge, fuse and int8-quantize, then serve through
continuous batching with speculative decoding over an int8 KV arena.

    python scripts/torch_train_demo.py                  # the card
    python scripts/torch_train_demo.py --device cpu --config llama3_train_test

It runs on the card unless ``--device cpu`` is given; without CUDA and
without it, it raises. ``--config`` is ``llama3_train_test`` (the JAX
demo's size, the default on the CPU) or ``llama3_train_bench`` (its full
width and depth, the default on the card). Every shard of the mesh lies on
the one device. Randomness comes from ``--seed`` alone: the weights and
adapters from ``torch.Generator`` seeds, the corpus and prompts from numpy.
With ``KATATPU_OBS=1`` the whole journey lands in one JSONL event stream
and the script prints its summary.

Each stage is a function (:func:`pretrain`, :func:`resume`,
:func:`lora_finetune`, :func:`prepare_for_serving`, :func:`serve`), so a
test or a card check can drive them one by one."""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Any, Optional

import numpy as np
import torch

if __name__ == "__main__":  # run as a file: the package sits beside scripts/
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kata_xpu_device_plugin_tpu_torch import models, obs, resolve_device  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models.transformer import (  # noqa: E402
    fuse_decoder_params,
)
from kata_xpu_device_plugin_tpu_torch.ops.lora import (  # noqa: E402
    LoRAWeight,
    apply_lora,
    make_lora_train_step,
    merge_lora,
)
from kata_xpu_device_plugin_tpu_torch.ops.quant import (  # noqa: E402
    quantize_decoder_params,
)
from kata_xpu_device_plugin_tpu_torch.parallel import (  # noqa: E402
    TrainCheckpointer,
    build_mesh,
    fit,
    make_loader,
    make_optimizer,
    make_train_step,
    shard_params,
)

MESH = {"data": 2, "fsdp": 2, "model": 2}

# Each config's journey. llama3_train_test is the JAX demo's own: its
# corpus, batch and window, the LoRA batch, the five prompts and the
# server. llama3_train_bench runs at a size its users train and serve at:
# B=16 windows of 1024 tokens (a flash-kernel length), LoRA rank 8 over
# 1024-token rows, 8 prompts of 64-1000 tokens, 64 new tokens each.
SIZES = {
    "llama3_train_test": dict(
        batch=8, seq_len=31, steps=8, preempt_at=4, ckpt_every=2,
        lora_rank=4, lora_steps=5, lora_lr=1e-3, lora_tokens=(8, 32),
        prompts=5, new_tokens=16,
        server=dict(max_batch=2, max_len=64, speculative_k=3,
                    spec_opt_in=True, kv_quant=True)),
    "llama3_train_bench": dict(
        batch=16, seq_len=1023, steps=8, preempt_at=4, ckpt_every=2,
        lora_rank=8, lora_steps=5, lora_lr=1e-3, lora_tokens=(8, 1024),
        prompts=8, new_tokens=64,
        server=dict(max_batch=4, max_len=2048, speculative_k=3,
                    spec_opt_in=True, kv_quant=True,
                    prefill_buckets=(128, 256, 512, 1024))),
}
LOADER_SEED = 1


def corpus_for(cfg, name: str, seed: int = 0) -> np.ndarray:
    """The token stream the journey pretrains on. The demo's size takes the
    JAX demo's ``arange(8192) % vocab``; the bench size a stream of 256
    random 64-token phrases drawn in a random order from ``seed`` (a
    pattern a few steps can learn), 16 batches long."""
    if name == "llama3_train_test":
        return np.arange(8192, dtype=np.int32) % cfg.vocab_size
    rng = np.random.default_rng(seed)
    phrases = rng.integers(0, cfg.vocab_size, (256, 64)).astype(np.int32)
    size = SIZES[name]
    n = 16 * size["batch"] * (size["seq_len"] + 1) // 64
    return phrases[rng.integers(0, len(phrases), n)].reshape(-1)


def prompts_for(corpus: np.ndarray, name: str, seed: int = 0) -> list:
    """The served prompts: the JAX demo's ``corpus[7i : 7i + 5 + i]`` at its
    size; at the bench size 8 slices of 64-1000 tokens at random offsets."""
    size = SIZES[name]
    if name == "llama3_train_test":
        return [corpus[i * 7: i * 7 + 5 + i] for i in range(size["prompts"])]
    rng = np.random.default_rng(seed + 3)
    lens = rng.integers(64, 1001, size["prompts"])
    starts = rng.integers(0, len(corpus) - 1000, size["prompts"])
    return [corpus[s: s + n].copy() for s, n in zip(starts, lens)]


def _train_pair(cfg, mesh, params: Optional[dict]):
    """``make_train_step(cfg, mesh=mesh)``'s pair; with ``params`` (whole
    fp32 tensors) the initial state holds them, cut onto the mesh, in
    place of ``init_params(cfg, seed)``'s draw."""
    optimizer = make_optimizer()
    init_state, step = make_train_step(cfg, optimizer, mesh=mesh)
    if params is None:
        return init_state, step

    def given(_seed: int = 0) -> dict:
        sp = shard_params(params, mesh)
        return {"params": sp, "opt": optimizer.init(sp), "step": 0}

    return given, step


def pretrain(cfg, mesh, corpus, ckpt_dir: Optional[str], steps: int,
             ckpt_every: int, seed: int = 0, batch: int = 8, seq_len: int = 31,
             params: Optional[dict] = None, on_step=None) -> tuple[Any, list]:
    """``fit`` over ``mesh`` for ``steps`` steps from ``init_params(cfg,
    seed)`` (or ``params``), batches of ``batch`` windows of ``seq_len +
    1`` tokens of ``corpus`` (loader seed 1, as in the JAX demo), a
    checkpoint every ``ckpt_every`` steps in ``ckpt_dir``. Returns
    ``(state, losses)``."""
    init_state, step = _train_pair(cfg, mesh, params)
    loader = make_loader(corpus, batch=batch, seq_len=seq_len, mesh=mesh,
                         seed=LOADER_SEED)
    return fit(init_state, step, loader, steps=steps, seed=seed,
               ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, on_step=on_step)


def resume(cfg, mesh, corpus, ckpt_dir: str, steps: int, ckpt_every: int,
           seed: int = 0, batch: int = 8, seq_len: int = 31,
           params: Optional[dict] = None, on_step=None) -> tuple[Any, list]:
    """:func:`pretrain` again over the same ``ckpt_dir``, which must hold a
    checkpoint: ``fit`` restores the state and the loader cursor and runs
    the steps the interrupted run had left, replaying it exactly. Returns
    ``(state, losses of the steps run)``."""
    if ckpt_dir is None or TrainCheckpointer(ckpt_dir).latest_step() is None:
        raise ValueError(f"no checkpoint to resume from in {ckpt_dir!r}")
    return pretrain(cfg, mesh, corpus, ckpt_dir, steps, ckpt_every, seed=seed,
                    batch=batch, seq_len=seq_len, params=params,
                    on_step=on_step)


def lora_finetune(params: dict, cfg, generator, rank: int = 4,
                  steps: int = 5, tokens=None, lr: float = 1e-3,
                  on_step=None) -> tuple[dict, list]:
    """Fresh rank-``rank`` adapters on wq/wk/wv/wo drawn from ``generator``
    (:func:`apply_lora`; a mesh state's pieces are gathered whole), then
    ``steps`` steps of ``make_lora_train_step(cfg, lr=lr)`` on ``tokens``,
    the base frozen. ``params`` that already carry adapters are tuned as
    they are (``generator`` unused). Returns ``(state, losses)``."""
    adapted = any(isinstance(v, LoRAWeight) for v in params["layers"].values())
    if not adapted:
        params = apply_lora(params, generator, rank=rank)
    init_state, step = make_lora_train_step(cfg, lr=lr)
    state = init_state(params)
    losses = []
    for i in range(steps):
        state, loss = step(state, tokens)
        losses.append(loss)
        if on_step is not None:
            on_step(i + 1, loss)
    return state, [float(x) for x in losses]


def prepare_for_serving(lora_params: dict) -> dict:
    """Merge the adapters, fuse the projections, int8-quantize the layer
    weights: the JAX demo's order (adapters cannot be fused, and fused
    matrices are what the int8 layout quantizes)."""
    return quantize_decoder_params(fuse_decoder_params(merge_lora(lora_params)))


def serve(params: dict, cfg, prompts: list, max_new_tokens: int = 16,
          **server_kwargs) -> tuple[list, GenerationServer]:
    """Continuous-batch ``prompts`` through a :class:`GenerationServer`
    built with ``server_kwargs`` (the journey's: speculative, int8 KV).
    Returns the outputs in prompt order and the drained server, for its
    ``stats()``."""
    srv = GenerationServer(params, cfg, **server_kwargs)
    rids = [srv.submit(p, max_new_tokens) for p in prompts]
    results = srv.run()
    return [results[r] for r in rids], srv


def lora_tokens(cfg, shape: tuple, generator: torch.Generator) -> torch.Tensor:
    """The fine-tune batch: uniform tokens from ``generator``."""
    return torch.randint(0, cfg.vocab_size, shape, generator=generator,
                         dtype=torch.int64, device=generator.device)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain PyTorch path (default: CUDA)")
    ap.add_argument("--config", choices=tuple(SIZES), default=None)
    ap.add_argument("--mesh", default=",".join(f"{k}={v}" for k, v in MESH.items()))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = args.config or ("llama3_train_test" if device.type == "cpu"
                           else "llama3_train_bench")
    size = SIZES[name]
    cfg = getattr(models, name)()
    shape = {k: int(v) for k, v in (p.split("=") for p in args.mesh.split(","))}
    mesh = build_mesh(shape, devices=[device])
    print(f"mesh: {mesh.shape}")

    # 1. corpus + pretrain with checkpointing, "preempted" part of the way
    corpus = corpus_for(cfg, name, args.seed)
    train = dict(batch=size["batch"], seq_len=size["seq_len"], seed=args.seed)
    with tempfile.TemporaryDirectory(prefix="torch_demo_ckpt_") as ckpt_dir:
        _, losses_a = pretrain(cfg, mesh, corpus, ckpt_dir, size["preempt_at"],
                               size["ckpt_every"], **train)
        print(f"pretrain (interrupted at {size['preempt_at']}): losses "
              f"{[round(x, 3) for x in losses_a]}")

        # 2. resume from the checkpoint: replays the interrupted run exactly
        state, losses_b = resume(cfg, mesh, corpus, ckpt_dir, size["steps"],
                                 size["ckpt_every"], **train)
    print(f"resumed to {size['steps']}:               losses "
          f"{[round(x, 3) for x in losses_b]}")

    # 3. LoRA fine-tune the pretrained params (base frozen)
    adapters = torch.Generator(device=device).manual_seed(args.seed + 1)
    toks = lora_tokens(cfg, size["lora_tokens"],
                       torch.Generator(device=device).manual_seed(args.seed + 2))
    lstate, lora_losses = lora_finetune(
        state["params"], cfg, adapters, rank=size["lora_rank"],
        steps=size["lora_steps"], tokens=toks, lr=size["lora_lr"])
    print(f"lora fine-tune: final loss {lora_losses[-1]:.3f}")

    # 4. merge + fuse + int8-quantize for serving
    served_params = prepare_for_serving(lstate["params"])

    # 5. serve: continuous batching + speculative decoding + int8 KV arena
    server = size["server"]
    outs, _ = serve(served_params, cfg, prompts_for(corpus, name, args.seed),
                    max_new_tokens=size["new_tokens"], device=device, **server)
    print(f"served {len(outs)} requests through {server['max_batch']} slots; "
          f"first output: {outs[0].tolist()}")

    # Telemetry: with KATATPU_OBS=1 the whole journey above (train steps,
    # prefills, TTFTs, speculative rounds) lands in one JSONL event stream.
    sink = obs.default_sink()
    if sink is not None:
        evs = obs.read_events(sink.path)
        print(f"obs: {sink.emitted} events -> {sink.path}")
        print(f"obs: train phases {obs.summarize_phases(evs, prefix='train.')}")
        ttfts = [e["ttft_s"] for e in evs if e["name"] == "ttft"]
        print(f"obs: {len(ttfts)} TTFTs, max {max(ttfts):.3f}s" if ttfts else "")
    print("demo complete")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
