#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card (``nvidia-smi`` name and power limit) and CUDA version;
2. build  — compile every kernel under ``kata_xpu_device_plugin_tpu_torch/csrc``;
3. check  — each kernel against its plain PyTorch version on the card,
   bf16, at the main paths' shapes and layouts, within the per-element and
   mean bounds of ``ops.attention.kernel_tolerance`` (for the backward
   kernels with the magnitudes ``ops.flash.backward_magnitudes`` derives);
   the forward's logsumexp in fp32. The flash forward at the serving
   prefill shapes, and where its tiles meet the masks and the sequence's
   end (full attention, D=64, window 96 with softcap 30, S=160 and 320, B=1
   S=128, GQA 4) with and without the lse, a second launch of each giving
   the same bits; timed by CUDA-graph replay beside SDPA's forward at the
   Gemma-2B prefill shape (the kernels line) and, with the lse, at the two
   training shapes (the ``flash_fwd_train`` line). The paged decode kernel
   walks permuted, non-contiguous tables with unmapped entries, ragged
   positions and a dead lane, at Gemma-2B and Llama-3-8B head shapes,
   single-query and as spans of 4 and 8 rows with ragged query lengths
   (real rows within the bound and bit-equal to a single-query launch at
   the row's position, padding rows finite and within max|V|), also at tile
   1024, whose chunks the split pass walks in pieces; the dense decode
   kernel at five shared positions; a second launch of each decode kernel
   on the same inputs must give the same bits; each decode kernel is also
   timed at a working set past the 50 MB L2 (paged int8, 64 lanes at
   position 4095, tile 16; dense bf16, 32 rows at position 4095), against
   its byte bound; both decode kernels at Qwen2-7B's heads (28 over 4, a
   GQA group of 7; paged int8 and bf16, tiles 16 and 128, a dead lane,
   single-query and spans of 4; dense at positions 5 and 2047), timed; the
   flash forward at the families' windowed prefill shapes (Gemma-2-2B:
   S=6144, window 4096, softcap 50; Gemma-3-4B: S=2048, window 1024),
   timed; the flash backward kernels at head_dim 64, 128 and 256
   (the Llama-3-8B and Gemma-2B train shapes timed, beside the ``delta``
   reduction and the SDPA backward), both with ``delta`` given and with the
   dq kernel forming it (``flash_backward``), and a second launch of each
   giving the same bits; the ring block API's kernels (K1: global offsets,
   the lse cotangent ``dlse`` in the backward) on the block pairs of an
   8192-token ring of 4 at Llama-3-8B's train shape (a full pair below the
   diagonal, the diagonal pair) and at Gemma-2-2B's local layers (window
   4096, softcap 50: a pair whose last row sees no key, and one the window
   does not reach), with a random ``dlse``, out on the live rows and the
   backward within their bounds, dead rows finite with lse <= NEG_INF / 2,
   relaunches bit-identical; the forward timed by graph replay, the dq
   and dk/dv kernels each alone by CUDA events, beside SDPA (no lse, no
   cap);
4. serve  — full-width Gemma-2B (random bf16 weights, fused) served by
   the default ``GenerationServer`` (overlapped rounds, int8 KV, chunk 8,
   each decode chunk after the first one CUDA graph replay): 16 requests;
   launch counts of both kernels reset just before and read just after,
   and for every server run: the paged kernel's launches equal rounds x
   chunk x decode_steps x layers, counted through the replays, one
   capture, and every round after the warm-up chunk a replay. Beside it
   the lock-step server (``overlap=False``) on the same requests: tok/s,
   TTFT, ITL, rounds and the token-match fraction (printed; the two loops
   may group admissions differently, and bf16 GEMMs at another batch round
   differently). Then ``graph_check``: one chunk by capture and replay
   against the same chunk run eagerly on a clone of the arena, tokens,
   ``last``, ``pos`` and every arena byte bit-equal, with the capture's
   seconds and its graph pool's bytes. Then two requests through the
   kernel path and the plain path: every layer's kernel call held against
   the plain version on its own inputs, and the logits held against the
   plain path's (``crosscheck``);
5. paged  — the same model served over a paged block pool:
   ``GenerationServer(max_batch=16, kv_pool_tokens=8000, kv_block_size=16)``,
   32 requests, overlapped; every decode step walks the lanes' real block
   tables with the paged kernel; the pool comes under pressure, so lanes
   are preempted, spilled and resumed. Asserted: every budget returned, at
   least one preemption, an empty pool at the end, more than 8 lanes at
   once. Beside it the lock-step paged server and the paged server at
   ``decode_steps=4`` on the same requests, and ``graph_check`` over the
   pool. Then one round of a loaded paged server with every layer's kernel
   call held against the plain version on its own inputs
   (``paged_crosscheck``), and the slotted server on the same requests for
   the token-match fraction;
5a. telemetry — the paged configuration's server with telemetry off and
   with the defaults (heartbeat every 32 rounds, device ledger, watchdog,
   tripwire) plus ``strict=True`` and a JSONL sink, 32 requests each, in
   turns twice: tokens equal, launches as in the paged phase, the
   heartbeat count of the cadence, ``0 < mfu <= 1`` and
   ``0 < device_busy_frac <= 1`` a heartbeat, the ledger's FLOPs within 25%
   of this script's count, ``hbm_*`` fields attributing at least the
   params and the pool, a second run with no compile and no new capture,
   one request trace a request summing to its wall time, the fields
   ``tools/obs_report.py`` reads; then a watchdog drill (an ITL budget no
   round meets: an alert and a flight dump holding the breach), strict
   mode's negative control (an injected ``.item()`` in the guarded round
   raises), and a 2-step ``fit`` at Llama-3-8B widths (2 layers) in
   ``train.step`` spans with a ``torch.profiler`` window
   (``KATATPU_OBS_PROFILE_*``) writing a trace. Printed: tok/s off and on
   and the cost of telemetry. Every other phase's default server arms the
   same telemetry (the JAX default);
6. persistent — the serve phase's 16 requests (slotted) and the paged
   phase's 32 (paged) through ``persistent=True`` servers (a round decodes
   until its cap of 256 steps, a lane's eos or budget, or a lane's window
   edge; one graph replay a step, the exit flag read from pinned memory),
   each beside the lock-step server on the same requests. Asserted: equal
   tokens; the exits partition the rounds; the tokens the rounds delivered
   are the tokens emitted past each first; paged kernel launches = steps
   executed x layers, counted through replays; fewer than ``sub_steps``
   steps a round past its exit. Printed: tok/s, ITL, rounds, steps
   delivered a round, exits, preemptions, steps past exits. Then
   ``persistent_graph_check`` for both arenas: a round by replay against
   the same round eager on a clone of the arena, every byte, with the
   paged eager round's kernel calls held against the plain version;
7. sched — the serve phase's config and requests through ``fifo_batch``
   and ``slo_chunked`` (``itl_slo_ms=0``, ``prefill_chunk=128``) fused and
   unfused, at the default deadline, and fused over a bf16 cache: tok/s,
   TTFT, ITL, chunks, fused admissions, the token match against fifo and
   the plain top-2 margin where they first part. Asserted: chunks ran and
   fused ones rode decode dispatches; each chunked admission's first-token
   logits within the serving bound of one read-back slice of the whole
   prompt, and over the bf16 cache of the whole plain prefill; a whole
   admission pass's flash calls within ``kernel_tolerance``;
7a. prefix — the shared-prefix cache and the host KV tier (``phase_prefix``);
7a'. guards — the repo's guards over the port (``phase_guards``,
   ``docs/torch_guards.md``): ``python -m tools.torchguard`` over this
   checkout must find nothing unsuppressed (its counts by rule and its
   sanctions printed), ``tests/torch_race_harness.py`` runs 20 seeded
   iterations with the kubelet-restart scenario (both in processes of
   their own, beside the drains), and one ``strict=True`` server of each
   serving form on the paged phase's config — paged int8 overlapped,
   fused admission, persistent rounds, ``slo_chunked``, the prefix cache
   with the host tier — drains 16 requests twice after its warm-up: no
   ``guard_trip`` event, no steady-state capture, compile or reshard, tok/s
   and the flash and paged-decode launches of each drain;
7b. tp — tensor-parallel serving with every shard on the one card: the
   shard-local paged decode kernel (K2) at the Gemma-2B (H=8, KV=1, D=256)
   and Qwen2-7B (H=28, KV=4, D=128) decode shapes, bf16 and int8, tiles 16
   and 128, tp 2 and 4, over lanes on one shard, lanes across shards and a
   dead lane: each shard's (acc, m, l) against the plain shard-local
   version, the merged output bit-equal to the unsharded kernel for lanes
   on one shard and within ``kernel_tolerance`` of the plain version,
   relaunches bit-identical, timed by graph replay beside the unsharded
   kernel and its byte bound; full-width Gemma-2B on the paged phase's
   pool and 32 requests at tp=1, tp=2 heads, tp=2 and tp=4 blocks (tok/s,
   TTFT, ITL, shard occupancies, launches = rounds x chunk x layers x
   shards, token match and the first parting's margin against tp=1), a
   tp=2 blocks ``graph_check``, each run's logits against the plain path
   (``tp_crosscheck``), and Qwen2-7B (4 layers) at tp=2 heads beside tp=1;
7b. resilience — crash-tolerant serving on the paged phase's server and
   requests (overlapped, int8 KV, telemetry on, ``strict=True``): a
   fault-free run, then a transient fault at ``decode_dispatch``,
   ``prefill``, ``admission_commit`` and ``pool_alloc`` and a ``fence``
   hang, with ``checkpoint_rounds=4`` and a fence watchdog: every rid
   served, a recovery a fault, the checkpoint-restored requests admitted
   before the first fault bit-equal to the fault-free run, paged launches
   = replays x chunk x layers through the recoveries (one capture: the
   reset is in place), the backend unchanged, no guard trip; a quarantine
   drill; then ``tp=4`` blocks losing shard 1: the shrink to 2, the
   shard-local kernel's launches 4 a step before and 2 after, one new
   capture; recovery latency by kind, checkpoint ms and bytes, shrink ms,
   tok/s against fault-free and the token match are printed
   (:func:`phase_resilience`);
8. generate — ``generate()`` at full width, B=8, prompt 128, 64 steps, bf16
   cache, under ``KATA_TPU_DECODE_KERNEL=1``: 18 x 63 launches of the dense
   decode kernel, each layer of the first decode step held against the
   plain version, and the token-match fraction against the run without
   the opt-in (which launches the dense kernel no time);
8a. spec — speculative decoding and ring/cycle KV arenas (PERF.md
   configuration 13, :func:`phase_spec`): full-width Gemma-2B with n-gram
   drafts (k=4), a 2-layer self draft and the target as its own draft
   beside the plain lock-step server (tok/s, rounds, acceptance, token
   match; every request's first parting must be a bf16 flip by the two
   tokens' plain logit gap, :func:`token_partings`; in an untimed second
   run the perfect draft's drafts must equal the verify's greedy tokens
   at 0.9 of their positions), the verify round's plain attention timed,
   ``generate_speculative`` against ``generate``; Gemma-2-2B (4 of 26
   layers, cut to keep the script in its time limit) and
   Mistral-7B (4 of 32) at max_len 8192 over four prompts of
   4200-6000 tokens with ``ring_kv``, and with ``ring_kv`` and k=4, beside
   the full arena (arena bytes and ratio, token match, partings that must
   be flips), one decode step a prompt over the ring against the full
   arena, ``generate(ring_kv=True)`` and ``decode(ring=True,
   return_state=True)``;
9. families — Gemma-2-2B (4 of 26 layers, max_len 8192, four prompts of
   4200-6000 tokens), Qwen2-7B (28 layers), Gemma-3-4B (6 of 34 layers,
   its cycles cut with it) and Mistral-7B (4 of 32 layers, max_len 8192,
   four long prompts) at their published widths, random bf16 weights, each
   through the default server over a paged pool (16 lanes, tile 16): 16
   greedy requests (Qwen2 decodes through the paged kernel at its group of
   7, counted; the windowed families with the plain attention by the JAX
   rule, reason printed), the same requests sampled (temperature 0.7,
   top-k 50, top-p 0.9, seed 0) by two servers that must give equal tokens,
   ``graph_check`` on a sampled chunk, and a prefill crosscheck (each
   layer's flash call against the plain version; logits within the serving
   bound or twice the run's noise floor); then ``generate()`` at Qwen2-7B
   widths with 4 layers under ``KATA_TPU_DECODE_KERNEL=1``
   (``generate_qwen2``, dense kernel at group 7);
10. train — Llama-3-8B at its published widths with 8 of its 32 layers
   (one card's memory), random fp32 parameters from seed 0, bf16 compute:
   ``make_train_step`` and ``fit`` for 6 AdamW steps on one repeated
   batch (B=2, S=2048); launch counts reset just before and read just
   after (8 forward, 8 dq and 8 dk/dv launches a step); the loss must be
   finite and fall. Then ``train_crosscheck``: one ``next_token_loss``
   backward at 2 layers, B=1, through the kernels (each layer's forward
   and backward kernel call held against the plain version on its own
   inputs) and through ``reference_attention``; the loss difference and
   the cosine of the whole gradient are printed;
11. train_gemma — the same at Gemma-2B's published widths (head_dim 256,
   MQA, GeGLU, tied and scaled embeddings) with 6 of its 18 layers: 4 steps
   (6 launches of each kernel a step), then its 2-layer crosscheck;
12. seq — sequence-parallel training: ``make_train_step(cfg,
   mesh=seq_mesh(4))`` and ``fit`` at Llama-3-8B's widths with 8 of its 32
   layers, B=1, S=8192 (ring attention over 4 shards of 2048 tokens, all on
   the one card), 4 steps: step time, tokens/s, MFU, peak memory, losses
   finite and falling; the K1 forward, dq and dk/dv kernels each launched
   exactly steps x layers x 10 live pairs, self-attention's kernels never.
   Then
   ``seq_crosscheck`` at 2 layers: every K1 call and each layer's merged
   output checked on its own inputs, the first step's loss and gradient
   norm at sp=4 beside sp=1 (the flash kernel). Then ``seq_gemma2``:
   Gemma-2-2B, 4 of its 26 layers, S=8192, sp=4, 3 steps (local layers,
   window 4096, 9 pairs each; global layers 10).

After ``spec``, the MoE, LoRA and W8A8 phases (PERF.md configurations 14-16;
``scripts/torch_moe_lora_phase.py`` runs them alone):
8b. w8a8 — Gemma-2B int8 fused served with W8A8 off and on (tok/s, the
   token match) and JAX's op bound at the ``wqkv`` and ``w_down`` shapes;
8c. kv_gate — the int8-KV gate's evidence at Gemma-2B width, its verdict
   printed, not asserted (its thresholds were set on a tiny model);
8d. lora — Gemma-2B with rank-8 adapters: fresh adapters bit-equal to the
   base server, 4 ``make_lora_train_step`` steps at S=1024 (loss falls,
   bases unchanged, flash backward launches = steps x layers), trained
   against merged within the serving bound, QLoRA over the int8 fused base
   served with ``graph_check``;
8e. moe — Mixtral-8x7B, 4 of 32 layers at published widths, served (paged,
   int8 KV, 16 lanes) with bf16 and then int8 experts: launches,
   ``graph_check`` (MoE dispatch in the replay), ``crosscheck``, tok/s,
   TTFT/ITL and the ledger's ``mfu``.

After ``moe``, training at scale, every shard on the one card (PERF.md
configurations 17-20; ``scripts/torch_train_scale_phase.py`` runs them
alone). Each first loss is held against the unsharded step's from the same
weights within :func:`rounding_bound`, and each kernel's launches are exact
a local block, with no operand copied:
8f. fsdp_tp — Llama-3-8B, 4 of 32 layers, over fsdp 2 x model 2 through
   ``fit`` with a sharded checkpoint at step 2 and a ``fit`` that resumes
   from it (step 3's loss bit for bit), 16 launches of each kernel a step;
   then one step over seq 2 x fsdp 2 x model 2 at S=4096 through K1;
8g. pipeline — Llama-3-8B, 4 layers, ``make_pp_train_step`` on
   ``composed_mesh(2, 2, 2)``, 4 microbatches of 2, 3 steps, beside the
   flat step over fsdp 4 x model 2 on the same weights and batch;
8h. ep_moe — Mixtral-8x7B, 1 layer, experts over the model axis of fsdp 1
   x model 2 at a capacity that drops nothing (a routing-flip term joins
   the bound), then each shard's drops at the default factor;
8i. lora_mesh — Gemma-2B rank-8 LoRA over fsdp 2 x model 2 beside the
   unsharded LoRA step, the bases unchanged;
8j. local_blocks — the flash kernels at those phases' local-block shapes
   against their plain versions, timed beside SDPA and the bound.

Then serving over a caller's mesh, MoE under tensor parallelism, the HF
conversion, the guest probe (PERF.md configurations 21-24;
``scripts/torch_serve_mesh_phase.py`` runs them alone) and the host
daemon (configuration 25):
8k. serve_mesh — ``GenerationServer(mesh=build_mesh({"fsdp": 2, "model":
   2}))`` beside the unsharded server: Gemma-2B, all 18 layers, the paged
   configuration's 32 requests (one KV head: ``kv_replicated``), and
   Llama-3-8B, 8 of 32 layers, 16 requests (KV heads cut), then its
   ``init_sharded_params`` tree served as it is, bit-equal in tokens to the
   mesh server over the plain tree; launches (paged = rounds x chunk x
   layers x 2), tok/s, TTFT, ITL, peak memory, ``graph_check``, partings
   that must be flips, and the fsdp gathers' device time a step
   (:func:`phase_serve_mesh`);
8l. moe_tp — Mixtral-8x7B, 4 of 32 layers, configuration 14's server
   (capacity factor 2.0) at tp=2 beside tp=1, bf16 then int8 experts:
   launches, tok/s, TTFT, ITL, ``graph_check`` and the tp=2 layer against
   ``moe_ffn`` with its capacity drops counted; partings that must be
   flips from an untimed pair served at E/K, where no copy drops (at 2.0
   a decode step's drops depend on the other lanes: a witness run with
   one request's budget cut, printed) (:func:`phase_moe_tp`);
8m. convert — Gemma-2B through ``to_hf_state_dict`` and ``from_hf`` in
   memory, every leaf and the served tokens bit-equal; Llama-3-8B (2
   layers) within the serving bound; seconds and peak host memory
   (:func:`phase_convert`);
8n. probe — ``guest.probe.run_ladder`` on the card, its three lines, every
   check ``ok``;
8o. host — the GPU daemon and the guest it hands the card to (PERF.md
   configuration 25, :func:`phase_host`; ``scripts/torch_multihost_phase.py
   --phases host`` runs it alone). A fresh daemon process, which never initializes CUDA
   (asserted): ``scan_gpus`` over this machine's real /sys, /dev and /proc
   finds ``torch.cuda.device_count()`` GPUs, each a char device 195:N with
   the minor, BDF and device id ``nvidia-smi`` gives (``[N/A]`` where the
   machine hides them); ``scan_vfio`` lists none of them; the manager
   writes the JSON CDI spec, read back and validated, every node in it
   present; an Allocate over the plugin's socket with int8 KV, 8 decode
   steps, a pool of 8000 tokens, a guest events dir and a heartbeat every
   4 rounds. The guest, a process started with exactly that allocation's
   env: the probe ladder, Gemma-2B (all 18 layers) served, 8 requests, by
   a server that takes those knobs from the env (launches by the launch
   rule, the knobs in ``stats()``, every event under the allocation's
   trace), ``graph_check``. The daemon then aggregates the guest's
   heartbeats under the granted device id. Printed: scan, spec write and
   Allocate ms, the guest's tok/s, beside the card's name and power limit;
8p. multihost — two daemons on this machine as workers 0 and 1 of one
   two-host membership (PERF.md configuration 26, :func:`phase_multihost`;
   ``scripts/torch_multihost_phase.py`` runs it alone): each ``python -m
   kata_xpu_device_plugin_tpu_torch run`` with its own state, CDI and
   socket dirs and a stand-in kubelet that answers pod-resources ``List``
   with what was granted; worker 0 by ``--worker-hostnames
   127.0.0.1,localhost --node-name 127.0.0.1``, worker 1 by a metadata
   dir (``0:127.0.0.1:8476,1:localhost:8476``, worker number 1). Asserted:
   both JSON specs carry one hostname list and the ids 0 and 1; ``status
   --json`` of each lists its pod assignment and leaves the state file's
   bytes and mtime unchanged; worker 1, restarted with its metadata dir
   emptied, keeps id 1 from its state file (its log says so); no daemon
   initializes CUDA. Two guests with their spec's and allocation's env:
   ``initialize_from_env(device="cpu")`` (gloo; NCCL refuses two ranks on
   one device, so no NCCL group is formed: item 10), each its
   ``make_loader`` stride of one global batch, together covering it;
   worker 0's guest serves ``gemma_2b_bench`` (18 layers, int8 KV from the
   env) 8 requests at 8 lanes by the launch rule, ``graph_check``;
8q. mesh_shards — the flash forward and the paged decode kernel at those
   servers' model-shard shapes against their plain versions, timed.

After the seq phases:

13. bench_configs — the JAX bench's configs (PERF.md configuration 27,
   :func:`phase_bench_configs`): ``fit`` of ``llama3_train_bench`` (all 12
   layers, head_dim 64) at B=16, S=1024 with remat, 4 steps, the loss
   falling and the launches exact (the forward twice a layer a step); its
   three flash kernels at ``[16, 1024, 16/8, 64]`` against their plain
   versions, timed beside SDPA and their bounds; the paged decode kernel
   at its heads (4 lanes, 16/8, 64), int8 and bf16, at the tile the
   ladder's ``generate`` takes (128) and over 16-row blocks with a dead
   lane, against its plain version; then
   ``scripts/torch_eval_quality.py --config llama3_train_bench --dtype
   bfloat16`` (its four rungs printed, the flash and paged kernels
   launched), and a second witness for its int8-KV rung: the same
   decodes through the plain attention, each kernel run against the plain
   run over its cache, the plain top-2 margin where the int8 runs part.
14. journey — ``scripts/torch_train_demo.py``'s stages at
   ``llama3_train_bench``'s full width and depth (PERF.md configuration
   29, :func:`phase_journey`): pretrain over data 2 x fsdp 2 x model 2 at
   B=16, S=1024 with a checkpoint every 2 steps, preempted at 4 and
   resumed to 8, bit-equal to an uninterrupted run; LoRA rank 8, 5 steps,
   the base frozen; merge, fuse, int8; 8 prompts served by the
   speculative int8-KV server and a paged reference server, every parting
   a flip; launches by the mesh rule, the LoRA steps and the reference's
   rounds; the flash kernels at a mesh block's shape and the paged decode
   kernel at the serving shape against their plain versions.

Then the ``{"kernels": [...]}`` line and, last, the device line.
``--profile`` adds ``torch.profiler`` windows over decode rounds of a loaded
server (slotted and paged, overlapped and lock-step; at least 48 steps,
all graph replays), each printing the card's idle share, and one over a step
of each train phase (and, in the families phase, a window of each
family's decode rounds). Any failed
phase raises: the script exits non-zero and prints no result. Without CUDA,
or outside a checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import stat
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "kata_xpu_device_plugin_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel against plain version: attention.kernel_tolerance, derived from
# where the two sides round to bf16. End to end, the kernel path's logits
# against the plain path's: max |difference| within these multiples of the
# plain logits' RMS. They are set from readings on an H100 (prefill 0.53-
# 0.55, first decode step 0.21-0.25; PERF.md), not derived: the random
# weights carry each layer's rounding difference on through 18 layers.
LOGIT_BOUND = {"prefill": 0.75, "decode": 0.35}
# The families run deeper (up to 28 layers), and random weights carry a
# rounding difference on through every layer: there, two equally valid bf16
# attentions (``plain_fp32_p`` against the plain version) already differ by
# 1-3x the logit RMS. A family's kernel path is held to the serving bound
# above or, past it, to this multiple of that noise floor measured in the
# same run on the same request (readings on an H100, PR 8: kernel against
# plain 0.85-1.10 x the noise floor for Gemma-2B and the four families).
NOISE_FACTOR = 2.0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of ``fn`` per call: ``iters`` calls captured in one CUDA
    graph, replayed between two CUDA events. A decode call takes less
    device time than its Python wrapper takes on the host, so back-to-back
    eager calls (``time_ms``) would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(name: str, out, ref, mag) -> dict:
    """Hold a kernel's output against the plain version's on the same
    inputs; ``mag`` is the plain version applied to |v|."""
    from kata_xpu_device_plugin_tpu_torch.ops.attention import kernel_tolerance

    res = {"case": name, **kernel_tolerance(out, ref, mag)}
    if not res.pop("ok"):
        raise AssertionError(f"{name}: kernel disagrees with plain version {res}")
    return res


def v_abs(v):
    """|v| for a bf16 tensor or an int8 QTensor (whose scales are >= 0)."""
    from kata_xpu_device_plugin_tpu_torch.ops.quant import QTensor

    return QTensor(v.q.abs(), v.scale) if isinstance(v, QTensor) else v.abs()


# ----- phases ---------------------------------------------------------------


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, cuda=torch.version.cuda,
         torch=torch.__version__, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def spilling_functions(log: str) -> dict:
    """ptxas -v output to ``{function: bytes of spill stores}``, for the
    functions that spill."""
    spills, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[-1].strip()
        elif "spill stores" in ln and fn is not None:
            n = int(ln.split("bytes spill stores")[0].split(",")[-1])
            if n:
                spills[fn] = n
    return spills


def phase_build() -> None:  # torchguard: allow(TL004) the nvcc builds are host work: nothing runs on the card
    from kata_xpu_device_plugin_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(_build.sources())
    regs = {
        n: [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
        for n, log in _build.build_log.items()
    }
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         sources=_build.sources(), ptxas=regs,
         spills={n: spilling_functions(log) for n, log in _build.build_log.items()})


def live_pairs(S: int, causal: bool = True, window: int = 0) -> float:
    """(q row, key) pairs one head attends: all, the causal triangle, or
    the causal band of ``window`` keys."""
    if not causal:
        return float(S * S)
    if window and window < S:
        return window * (window + 1) / 2 + (S - window) * window
    return S * (S + 1) / 2


def flash_fwd_bound(B, S, H, KV, D, causal=True, lse=False, window=0) -> dict:
    """The least time the card could take for the forward: two D-long
    products a live (q row, key) pair over the bf16 peak, or q, k and v
    read once and the output (and the lse) written once over the memory
    rate, the larger."""
    pairs = B * H * live_pairs(S, causal, window)
    t_ops = 4.0 * D * pairs / PEAK_BF16_FLOPS
    nbytes = 2.0 * B * S * D * (2 * H + 2 * KV) + (4.0 * B * H * S if lse else 0.0)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def flash_case(name, B, S, H, KV, D, causal=True, window=0, softcap=0.0,
               lse=False, timed=False):
    """q/k/v are slices of one fused ``[B, S, (H + 2 KV) D]`` projection,
    the strided layout the transformer's fused ``wqkv`` hands the kernel.
    The kernel without the lse is held against the plain version; with
    ``lse`` the instantiation that writes it too, its lse within LSE_TOL. A
    second launch of each must give the same bits. ``timed``: the kernel
    (with the lse when ``lse``) and SDPA by CUDA-graph replay, the eager
    call beside them."""
    import torch
    import torch.nn.functional as F

    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward, flash_reference

    g = torch.Generator(device="cuda").manual_seed(B * S + H + D)
    qkv = torch.randn(B, S, (H + 2 * KV) * D, generator=g, device="cuda",
                      dtype=torch.bfloat16)
    q = qkv[..., : H * D].reshape(B, S, H, D)
    k = qkv[..., H * D: (H + KV) * D].reshape(B, S, KV, D)
    v = qkv[..., (H + KV) * D:].reshape(B, S, KV, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    rkw = dict(causal=causal, window=window, logits_softcap=softcap)
    out = flash_forward(q, k, v, **kw)
    ref = reference_attention(q, k, v, **rkw)
    mag = reference_attention(q.float(), k.float(), v.abs().float(), **rkw)
    torch.cuda.synchronize()
    res = check(name, out, ref, mag)
    relaunch_equal(name, out, flash_forward(q, k, v, **kw))
    if lse:
        out_l, lse_k = flash_forward(q, k, v, return_lse=True, **kw)
        _, ref_lse = flash_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        res_l = check(f"{name} (lse)", out_l, ref, mag)
        for f in ("max_abs_err", "max_err_over_bound"):
            res[f] = max(res[f], res_l[f])
        res["lse_max_abs_err"] = check_lse(name, lse_k, ref_lse)
        again = flash_forward(q, k, v, return_lse=True, **kw)
        relaunch_equal(f"{name} (lse)", out_l, again[0])
        relaunch_equal(f"{name} lse", lse_k, again[1])
    del ref, mag
    if timed:
        call = lambda: flash_forward(q, k, v, return_lse=lse, **kw)  # noqa: E731
        res["ms"] = graph_ms(call, 20)
        res["call_ms"] = time_ms(call, 20)
        if lse:
            res["plain_ms"] = time_ms(lambda: flash_reference(q, k, v, **kw), 3, 1)
        else:
            res["plain_ms"] = time_ms(lambda: reference_attention(q, k, v, **rkw),
                                      3, 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if softcap:
            res["library_ms"] = None  # no PyTorch call caps the logits
        elif window:  # SDPA with the band as a mask computes the same
            i = torch.arange(S, device="cuda")
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True), 20)
        else:
            res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        res.update(flash_fwd_bound(B, S, H, KV, D, causal, lse, window))
    emit("check", kernel="flash_fwd", B=B, S=S, H=H, KV=KV, D=D, causal=causal,
         window=window, softcap=softcap, lse=lse, relaunch_bit_equal=True, **res)
    return res


def relaunch_equal(name: str, out, again) -> None:
    """The decode kernels' split-K merge and the backward kernels' sums run
    in a fixed order with no atomics: a second launch on the same inputs
    must give the same bits."""
    import torch

    if not torch.equal(out, again):
        raise AssertionError(f"{name}: a second launch gave other bits")


def decode_bound(keys: float, B, SQ, H, KV, D, nb, quantized, flops,
                 out_bytes=None) -> dict:
    """The least time the card could take for a paged decode call that must
    read ``keys`` K rows and as many V rows once (payload and, for int8,
    scale), q and the tables once, and write the output once (``out_bytes``,
    by default the bf16 ``[B, SQ, H, D]``)."""
    row_bytes = D * (1 if quantized else 2) + (4 if quantized else 0)
    if out_bytes is None:
        out_bytes = 2 * B * SQ * H * D
    nbytes = (2 * keys * KV * row_bytes + 2 * B * SQ * H * D + out_bytes
              + 4 * B * (nb + 2))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def paged_inputs(B, H, KV, D, bs, quantized, max_len=2048, dead=False,
                 full=False):
    """A paged decode call's inputs on the card: a pool whose block 0 is the
    ZERO block, permuted tables whose entries past each lane's position are
    unmapped, random positions (every lane at the view's last if ``full``;
    the last lane dead, past its table, if ``dead``). Returns ``(q, k, v,
    tables, pos, kw)``."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(bs + B + int(quantized))
    nb = max_len // bs
    nt = (2 + B * nb) * bs
    q = torch.randn(B, 1, H, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pk = torch.randn(1, nt, KV, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pv = torch.randn(1, nt, KV, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pk[0, :bs] = 0.0
    pv[0, :bs] = 0.0  # block 0 is the ZERO block
    pos = torch.randint(0, max_len, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    if full:  # every lane at the view's last position
        pos.fill_(max_len - 1)
    if dead:
        pos[-1] = 10_000  # a dead lane's stale position, past its table
    perm = torch.randperm(B * nb, generator=g, device="cuda").to(torch.int32) + 2
    tables = perm.reshape(B, nb).clone()
    live = torch.arange(nb, device="cuda")[None, :] <= (pos // bs)[:, None]
    tables = torch.where(live, tables, torch.zeros_like(tables))  # unmapped: ZERO
    k, v = (quantize_kv(pk), quantize_kv(pv)) if quantized else (pk, pv)
    return q, k, v, tables, pos, dict(block_size=bs, paged_len=max_len)


def decode_case(name, B, H, KV, D, bs, quantized, max_len=2048, timed=False,
                dead=False, full=False):
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        paged_decode_attention,
        paged_decode_reference,
    )

    q, k, v, tables, pos, kw = paged_inputs(B, H, KV, D, bs, quantized, max_len,
                                            dead, full)
    nb = max_len // bs
    out = paged_decode_attention(q, k, v, tables, pos, **kw)
    ref = paged_decode_reference(q, k, v, tables, pos, **kw)
    mag = paged_decode_reference(q.float(), k, v_abs(v), tables, pos, **kw)
    torch.cuda.synchronize()
    res = check(name, out, ref, mag)
    del ref, mag
    relaunch_equal(name, out, paged_decode_attention(q, k, v, tables, pos, **kw))
    if timed:
        call = lambda: paged_decode_attention(q, k, v, tables, pos, **kw)  # noqa: E731
        res["ms"] = graph_ms(call, 20)
        res["call_ms"] = time_ms(call, 20)
        res["plain_ms"] = time_ms(
            lambda: paged_decode_reference(q, k, v, tables, pos, **kw), 5, 1)
        res["library_ms"] = None  # no single PyTorch call computes it
        keys = float((pos.clamp(max=max_len - 1) + 1).sum())
        res.update(decode_bound(keys, B, 1, H, KV, D, nb, quantized,
                                4.0 * H * D * keys))
    emit("check", kernel="paged_decode", B=B, H=H, KV=KV, D=D, bs=bs,
         int8=quantized, pos=pos.tolist(), **res)
    return res


def decode_mq_case(name, B, H, KV, D, bs, quantized, SQ, max_len=2048,
                   timed=False):
    """The multi-query form: spans of ``SQ`` right-aligned rows with ragged
    query lengths (``q_len = 1`` lanes beside full-width ones) through
    permuted tables; the last lane is dead. Real rows are held to the plain
    version and must equal, bit for bit, a single-query launch at the row's
    own position; padding rows must be finite and within max|V|."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        paged_decode_attention,
        paged_decode_reference,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    g = torch.Generator(device="cuda").manual_seed(bs + B + SQ + int(quantized))
    nb = max_len // bs
    nt = (2 + B * nb) * bs
    q = torch.randn(B, SQ, H, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pk = torch.randn(1, nt, KV, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pv = torch.randn(1, nt, KV, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pk[0, :bs] = 0.0
    pv[0, :bs] = 0.0  # block 0 is the ZERO block
    pos = torch.randint(SQ - 1, max_len, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    pos[0] = SQ - 1  # the shortest span that fits
    pos[-1] = 10_000  # dead lane
    q_lens = torch.randint(1, SQ + 1, (B,), generator=g, device="cuda",
                           dtype=torch.int32)
    q_lens[0], q_lens[1], q_lens[2] = SQ, 1, SQ
    perm = torch.randperm(B * nb, generator=g, device="cuda").to(torch.int32) + 2
    tables = perm.reshape(B, nb).clone()
    live = torch.arange(nb, device="cuda")[None, :] <= (pos // bs)[:, None]
    tables = torch.where(live, tables, torch.zeros_like(tables))  # unmapped: ZERO
    k, v = (quantize_kv(pk), quantize_kv(pv)) if quantized else (pk, pv)
    kw = dict(block_size=bs, paged_len=max_len)
    out = paged_decode_attention(q, k, v, tables, pos, q_lens, **kw)
    ref = paged_decode_reference(q, k, v, tables, pos, q_lens, **kw)
    mag = paged_decode_reference(q.float(), k, v_abs(v), tables, pos, q_lens, **kw)
    torch.cuda.synchronize()
    real = torch.arange(SQ, device="cuda")[None, :] >= SQ - q_lens[:, None]
    real[-1] = False  # the dead lane's span straddles nothing real
    res = check(name, out[real], ref[real], mag[real])
    v_max = float(dequantize_kv(v, torch.bfloat16).float().abs().max())
    pad_max = float(out.float().abs().max())
    if not (math.isfinite(pad_max) and pad_max <= v_max):
        raise AssertionError(f"{name}: padding rows not finite within max|V| "
                             f"({pad_max} > {v_max})")
    for j in range(SQ):
        one = paged_decode_attention(q[:, j:j + 1].contiguous(), k, v, tables,
                                     pos - (SQ - 1) + j, **kw)
        if not torch.equal(out[real[:, j], j], one[real[:, j], 0]):
            raise AssertionError(f"{name}: row {j} differs from the single-"
                                 "query launch at its position")
    res["rows_bit_equal_single_query"] = int(real.sum())
    if timed:
        call = lambda: paged_decode_attention(  # noqa: E731
            q, k, v, tables, pos, q_lens, **kw)
        res["ms"] = graph_ms(call, 20)
        res["call_ms"] = time_ms(call, 20)
        res["plain_ms"] = time_ms(lambda: paged_decode_reference(
            q, k, v, tables, pos, q_lens, **kw), 5, 1)
        res["library_ms"] = None
        live_pos = pos[:-1].float()
        keys = float((live_pos + 1).sum())
        row_pos = (live_pos[:, None] - (SQ - 1)
                   + torch.arange(SQ, device="cuda")[None, :])
        pairs = float(((row_pos + 1) * real[:-1]).sum())
        res.update(decode_bound(keys, B, SQ, H, KV, D, nb, quantized,
                                4.0 * H * D * pairs))
    emit("check", kernel="paged_decode", form="multi_query", SQ=SQ, B=B, H=H,
         KV=KV, D=D, bs=bs, int8=quantized, pos=pos.tolist(),
         q_lens=q_lens.tolist(), **res)
    return res


def dense_inputs(B, S, H, KV, D, pos):
    """A dense decode call's inputs on the card: one query token a row, a
    dense bf16 cache ``[B, S, KV, D]``, a device-scalar position."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(S + H + D + pos)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q, k, v = rnd(B, 1, H, D), rnd(B, S, KV, D), rnd(B, S, KV, D)
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda")


def sdpa_call(q, k, v, pos: int):
    """``scaled_dot_product_attention`` over ``k[:, :pos+1]``: the library
    call that computes what the dense kernel does (timed, never used)."""
    import torch.nn.functional as F

    qt = q.transpose(1, 2)
    kt, vt = (t[:, :pos + 1].transpose(1, 2) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)


def dense_case(name, B, S, H, KV, D, pos, timed=False):
    """The lock-step dense kernel: one token per row into a dense bf16 cache
    read in place, one device-scalar position for the whole batch."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        decode_attention,
        decode_attention_reference,
    )

    q, k, v, p = dense_inputs(B, S, H, KV, D, pos)
    out = decode_attention(q, k, v, p)
    ref = decode_attention_reference(q, k, v, p)
    mag = decode_attention_reference(q.float(), k.float(), v.abs().float(), p)
    torch.cuda.synchronize()
    res = check(name, out, ref, mag)
    del ref, mag
    relaunch_equal(name, out, decode_attention(q, k, v, p))
    if timed:
        res["ms"] = graph_ms(lambda: decode_attention(q, k, v, p), 20)
        res["call_ms"] = time_ms(lambda: decode_attention(q, k, v, p), 20)
        res["plain_ms"] = time_ms(lambda: decode_attention_reference(q, k, v, p), 5, 1)
        res["library_ms"] = graph_ms(sdpa_call(q, k, v, pos), 20)
        nbytes = 2 * 2.0 * B * (pos + 1) * KV * D + 2 * 2.0 * B * H * D + 4
        flops = 4.0 * B * H * D * (pos + 1)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
        res.update(bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops > t_bytes else "bytes")
    emit("check", kernel="dense_decode", B=B, S=S, H=H, KV=KV, D=D, pos=pos, **res)
    return res


# The forward's logsumexp against the plain version's, fp32: both form it
# from fp32 logits of the same bf16 inputs and differ only in summation
# order (~1e-6 relative); a masking or scaling fault moves it by O(1).
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


def check_lse(name: str, lse, ref) -> float:
    import torch

    err = float((lse - ref).abs().max())
    if not (math.isfinite(err) and torch.allclose(lse, ref, **LSE_TOL)):
        raise AssertionError(f"{name}: logsumexp disagrees with plain ({err})")
    return err


def check_grads(name: str, got, want, mags) -> dict:
    """dq, dk and dv of a backward kernel call against the plain version's
    on the same inputs, within the bound ``flash.backward_magnitudes``
    derives; returns one result per gradient."""
    return {g: check(f"{name} {g}", a, b, m)
            for g, a, b, m in zip(("dq", "dk", "dv"), got, want, mags)}


def bwd_case(name, B, S, H, KV, D, causal=True, window=0, softcap=0.0,
             timed=False):
    """The forward with its logsumexp, then the two backward kernels, on
    contiguous ``[B, S, heads, D]`` q/k/v and dout (the training layout:
    q and k come out of rope, v out of its own projection): each wrapper
    with the ``delta`` reduction given, and ``flash_backward``, whose dq
    kernel forms delta itself; a second launch of each must give the same
    bits (each element summed in a fixed order, no atomics)."""
    import torch
    import torch.nn.functional as F

    from kata_xpu_device_plugin_tpu_torch.ops import flash

    g = torch.Generator(device="cuda").manual_seed(7 * B * S + H + KV + D)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q, k, v, do = rnd(B, S, H, D), rnd(B, S, KV, D), rnd(B, S, KV, D), rnd(B, S, H, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash.flash_forward(q, k, v, return_lse=True, **kw)
    ref_out, ref_lse = flash.flash_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    lse_err = check_lse(name, lse, ref_lse)
    del ref_out, ref_lse
    delta = flash._delta(out, do)
    got = (flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
           *flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    fused = flash.flash_backward(q, k, v, out, lse, do, **kw)
    want = flash.flash_backward_reference(q, k, v, out, lse, do, **kw)
    mags = flash.backward_magnitudes(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    res = check_grads(name, got, want, mags)
    res_fused = check_grads(f"{name} (delta in dq)", fused, want, mags)
    del want, mags
    for gname, a, b in zip(("dq", "dk", "dv"), fused,
                           flash.flash_backward(q, k, v, out, lse, do, **kw)):
        relaunch_equal(f"{name} {gname}", a, b)
    del fused
    row = {"dq": {"case": name, **res["dq"]},
           "dkv": {"case": name,
                   **{f: max(res["dk"][f], res["dv"][f]) for f in
                      ("max_abs_err", "mean_abs_err", "max_err_over_bound")},
                   "mean_bound": min(res["dk"]["mean_bound"],
                                     res["dv"]["mean_bound"])}}
    for key, grads in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
        row[key]["max_err_over_bound"] = max(
            row[key]["max_err_over_bound"],
            *(res_fused[g_]["max_err_over_bound"] for g_ in grads))
    if timed:
        ms_dq = time_ms(lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw), 10)
        ms_dkv = time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw), 10)
        ms_delta = time_ms(lambda: flash._delta(out, do), 10)
        ms_backward = time_ms(lambda: flash.flash_backward(
            q, k, v, out, lse, do, **kw), 10)
        plain = time_ms(lambda: flash.flash_backward_reference(
            q, k, v, out, lse, do, **kw), 3, 1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                enable_gqa=True)
        do_t = do.transpose(1, 2)
        library = time_ms(lambda: torch.autograd.grad(
            o_sdpa, (qt, kt, vt), do_t, retain_graph=True), 10)
        pairs = B * H * (S * (S + 1) / 2 if causal else S * S)
        in_bytes = 2.0 * B * S * D * (2 * H + 2 * KV) + 8.0 * B * H * S
        for key, ms, products, out_bytes in (
                ("dq", ms_dq, 3, 2.0 * B * S * H * D),
                ("dkv", ms_dkv, 4, 4.0 * B * S * KV * D)):
            flops = products * 2.0 * D * pairs
            nbytes = in_bytes + out_bytes
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
            row[key].update(ms=ms, plain_ms=plain, library_ms=library,
                            bound_ms=1e3 * max(t_ops, t_bytes),
                            bound_by="operations" if t_ops > t_bytes else "bytes")
        # Like for like with the SDPA backward: the two kernels plus the
        # delta reduction they are given, and flash_backward (delta formed
        # in the dq kernel).
        row["dq"].update(delta_ms=ms_delta, pair_with_delta_ms=ms_dq + ms_dkv + ms_delta,
                         flash_backward_ms=ms_backward)
    timing = {f"{k_}_{f}": row[k_][f] for k_ in ("dq", "dkv") for f in
              ("ms", "plain_ms", "library_ms", "bound_ms", "delta_ms",
               "pair_with_delta_ms", "flash_backward_ms") if f in row[k_]}
    emit("check", kernel="flash_bwd", B=B, S=S, H=H, KV=KV, D=D, causal=causal,
         window=window, softcap=softcap, lse_max_abs_err=lse_err,
         **{k_: {f: v_ for f, v_ in r.items() if f != "case"}
            for k_, r in res.items()},
         delta_in_dq={k_: r["max_err_over_bound"] for k_, r in res_fused.items()},
         relaunch_bit_equal=True, **timing)
    return row


def block_bound(S, H, KV, D, pairs: int, products: int, in_bytes: float,
                out_bytes: float) -> dict:
    """The least time for a block pair's call: ``products`` D-long products
    a live (q row, key) pair of each head over the bf16 peak, or its inputs
    read once and its outputs written once over the memory rate."""
    t_ops = products * 2.0 * D * H * pairs / PEAK_BF16_FLOPS
    t_bytes = (in_bytes + out_bytes) / PEAK_HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def sdpa_band(S, q_off, k_off, window):
    """The block pair's live set as SDPA's boolean mask ``[S, S]``, or None
    where ``is_causal`` (the diagonal) or no mask (below it) says it."""
    import torch

    if window == 0 and q_off == k_off:
        return None
    if window == 0 and k_off + S - 1 <= q_off:
        return None
    qp = q_off + torch.arange(S, device="cuda")[:, None]
    kp = k_off + torch.arange(S, device="cuda")[None, :]
    band = kp <= qp
    if window:
        band &= kp > qp - window
    return band


def block_case(name, S, H, KV, D, q_off, k_off, window=0, softcap=0.0,
               timed=False):
    """The ring block API's kernels (K1) on one block pair at global offsets,
    B=1, contiguous ``[1, S, heads, D]`` q/k/v and dout (the training
    layout) and a nonzero random ``dlse``: the forward's out on the rows
    with a live key within ``kernel_tolerance`` of the plain version, its
    lse within LSE_TOL there; a row with no live key finite with lse <=
    NEG_INF / 2 (a pair with no live key gives 0, as the TPU kernel's
    finalize of rows none of whose blocks it visits); the backward (dq
    forming delta - dlse, then dk/dv) within the bound
    ``backward_magnitudes`` derives with the dlse term; a second
    launch of each giving the same bits. ``timed``: the forward by CUDA-
    graph replay, the dq kernel (forming delta - dlse) and the dk/dv kernel
    each alone by CUDA events, beside the plain versions and SDPA (with
    ``is_causal`` on the diagonal, no mask below it, the band as a mask
    with a window; SDPA returns no lse and takes no cap). Returns the
    forward's, dq's and dk/dv's rows."""
    import torch
    import torch.nn.functional as F

    from kata_xpu_device_plugin_tpu_torch.ops import flash
    from kata_xpu_device_plugin_tpu_torch.ops.attention import NEG_INF

    g = torch.Generator(device="cuda").manual_seed(S + H + D + q_off + window)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q, k, v, do = rnd(1, S, H, D), rnd(1, S, KV, D), rnd(1, S, KV, D), rnd(1, S, H, D)
    dlse = torch.randn(1, H, S, generator=g, device="cuda")
    kw = dict(causal=True, window=window, softcap=softcap)
    off = dict(q_off=q_off, k_off=k_off)
    out, lse = flash.flash_block_forward(q, k, v, q_off, k_off, **kw)
    ref, ref_lse = flash.flash_reference(q, k, v, **off, **kw)
    mag, _ = flash.flash_reference(q.float(), k.float(), v.abs().float(), **off, **kw)
    torch.cuda.synchronize()
    live = flash.live_rows(S, S, True, window, q_off, k_off).cuda()
    dead = int((~live).sum())
    if not (torch.isfinite(out.float()).all()
            and bool((lse[:, :, ~live] <= NEG_INF / 2).all())):
        raise AssertionError(f"{name}: a row with no live key is not finite "
                             "with lse <= NEG_INF / 2")
    if live.any():
        fwd = {"case": name, **check(f"{name} fwd", out[:, live], ref[:, live],
                                     mag[:, live]),
               "lse_max_abs_err": check_lse(name, lse[:, :, live],
                                            ref_lse[:, :, live])}
    elif out.any():  # no live row: every warpgroup skips every tile
        raise AssertionError(f"{name}: a pair with no live key must give 0, "
                             "as the TPU kernel's finalize of unvisited rows")
    else:
        fwd = {"case": name, "max_abs_err": 0.0, "max_err_over_bound": 0.0}
    again = flash.flash_block_forward(q, k, v, q_off, k_off, **kw)
    relaunch_equal(f"{name} fwd", out, again[0])
    relaunch_equal(f"{name} lse", lse, again[1])
    del ref, mag, ref_lse, again
    got = flash.flash_block_backward(q, k, v, out, lse, do, dlse, q_off, k_off, **kw)
    want = flash.flash_backward_reference(q, k, v, out, lse, do, dlse=dlse, **off,
                                          **kw)
    mags = flash.backward_magnitudes(q, k, v, out, lse, do, dlse=dlse, **off, **kw)
    torch.cuda.synchronize()
    res = check_grads(f"{name} bwd", got, want, mags)
    del want, mags
    for gname, a, b in zip(("dq", "dk", "dv"), got, flash.flash_block_backward(
            q, k, v, out, lse, do, dlse, q_off, k_off, **kw)):
        relaunch_equal(f"{name} {gname}", a, b)
    dq = {"case": name, **res["dq"]}
    dkv = {"case": name, **{f: max(res["dk"][f], res["dv"][f]) for f in (
        "max_abs_err", "mean_abs_err", "max_err_over_bound")},
           "mean_bound": min(res["dk"]["mean_bound"], res["dv"]["mean_bound"])}
    pairs = int(flash._mask(S, S, True, window, q_off, k_off, "cpu").sum())
    if timed:
        fwd["ms"] = graph_ms(lambda: flash.flash_block_forward(
            q, k, v, q_off, k_off, **kw), 20)
        fwd["call_ms"] = time_ms(lambda: flash.flash_block_forward(
            q, k, v, q_off, k_off, **kw), 20)
        fwd["plain_ms"] = time_ms(lambda: flash.flash_reference(
            q, k, v, **off, **kw), 3, 1)
        _, delta = flash.flash_block_bwd_dq(q, k, v, out, lse, do, dlse, q_off,
                                            k_off, **kw)
        dq["ms"] = time_ms(lambda: flash.flash_block_bwd_dq(
            q, k, v, out, lse, do, dlse, q_off, k_off, **kw), 10)
        dkv["ms"] = time_ms(lambda: flash.flash_block_bwd_dkv(
            q, k, v, do, lse, delta, q_off, k_off, **kw), 10)
        dq["block_backward_ms"] = time_ms(lambda: flash.flash_block_backward(
            q, k, v, out, lse, do, dlse, q_off, k_off, **kw), 10)
        dq["plain_ms"] = dkv["plain_ms"] = time_ms(
            lambda: flash.flash_backward_reference(
                q, k, v, out, lse, do, dlse=dlse, **off, **kw), 3, 1)
        band = sdpa_band(S, q_off, k_off, window)
        causal = band is None and q_off == k_off
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=band, is_causal=causal, enable_gqa=True)
        fwd["library_ms"] = graph_ms(sdpa, 20)
        o_sdpa = sdpa()
        do_t = do.transpose(1, 2)
        # The SDPA backward computes all three gradients: it stands beside
        # each kernel, as for the self-attention rows.
        dq["library_ms"] = dkv["library_ms"] = time_ms(
            lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), do_t,
                                        retain_graph=True), 10)
        note = ("SDPA returns no lse" + (" and takes no cap" if softcap else "")
                + ("; band as a boolean mask" if band is not None else ""))
        fwd["library_note"] = dq["library_note"] = dkv["library_note"] = note
        bf16 = 2.0 * S * D
        fwd.update(block_bound(S, H, KV, D, pairs, 2, bf16 * (H + 2 * KV),
                               bf16 * H + 4.0 * H * S))
        # dq: S, dP and dq, three products a pair; q, k, v, dout, out, lse
        # and dlse read, dq and delta - dlse written. dk/dv: S^T, dP^T, dk
        # and dv, four; q, k, v, dout, lse and delta read, dk and dv
        # written.
        dq.update(block_bound(S, H, KV, D, pairs, 3,
                              bf16 * (3 * H + 2 * KV) + 8.0 * H * S,
                              bf16 * H + 4.0 * H * S))
        dkv.update(block_bound(S, H, KV, D, pairs, 4,
                               bf16 * (2 * H + 2 * KV) + 8.0 * H * S,
                               bf16 * 2 * KV))
    emit("check", kernel="flash_block", S=S, H=H, KV=KV, D=D, q_off=q_off,
         k_off=k_off, window=window, softcap=softcap, live_pairs_a_head=pairs,
         dead_rows=dead, relaunch_bit_equal=True,
         fwd={k_: v_ for k_, v_ in fwd.items() if k_ != "case"},
         dq={k_: v_ for k_, v_ in dq.items() if k_ != "case"},
         dkv={k_: v_ for k_, v_ in dkv.items() if k_ != "case"},
         grads={k_: {f: r[f] for f in ("max_abs_err", "max_err_over_bound")}
                for k_, r in res.items()})
    return fwd, dq, dkv


def bandwidth_fields(prefix: str, res: dict) -> dict:
    """Move a timed case's times out of its check result (the kernels
    line's timed case stays the main path's shape), with its share of the
    bound."""
    out = {f"{prefix}_{f}": res.pop(f) for f in (
        "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    out[f"{prefix}_share_of_bound"] = out[f"{prefix}_bound_ms"] / out[f"{prefix}_ms"]
    return out


def phase_checks() -> dict:
    results = {"flash_fwd": [], "paged_decode": [], "dense_decode": [],
               "flash_bwd_dq": [], "flash_bwd_dkv": []}
    f = results["flash_fwd"]
    for B in (1, 8):  # the serving run's prefill groups: N = 1-8 at S 128-1024
        for S in (128, 256):
            f.append(flash_case(f"gemma2b B{B} S{S}", B, S, 8, 1, 256))
    f.append(flash_case("gemma2b B4 S512", 4, 512, 8, 1, 256))
    f.append(flash_case("gemma2b B4 S1024", 4, 1024, 8, 1, 256, timed=True))
    f.append(flash_case("gemma2b B4 S2048", 4, 2048, 8, 1, 256))
    f.append(flash_case("llama3-8b B2 S2048", 2, 2048, 32, 8, 128))
    f.append(flash_case("window+softcap", 2, 256, 4, 2, 128, window=64,
                        softcap=50.0))
    # Where the forward's tiles meet the masks and the sequence's end, each
    # also through the instantiation that writes the lse.
    for args, kw in (
            (("non-causal", 2, 256, 8, 2, 128), dict(causal=False)),
            (("D64", 2, 256, 8, 2, 64), {}),
            (("D256 window96+softcap30", 1, 320, 4, 1, 256),
             dict(window=96, softcap=30.0)),
            (("S160 part tile", 2, 160, 8, 2, 128), {}),
            (("S320 part tile MQA", 1, 320, 8, 1, 256), {}),
            (("B1 S128 lse", 1, 128, 8, 1, 256), {}),
            (("GQA4", 2, 256, 16, 4, 128), {})):
        f.append(flash_case(*args, lse=True, **kw))
    # The training shapes, timed with the lse; the kernels line's timed case
    # stays the prefill shape, these go beside it.
    train = {}
    for model, shape in (("llama3_8b", (2, 2048, 32, 8, 128)),
                         ("gemma2b", (2, 2048, 8, 1, 256))):
        c = flash_case(f"{model} train B2 S2048", *shape, lse=True, timed=True)
        train.update({f"{model}_{k_}": c.pop(k_) for k_ in (
            "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        f.append(c)
    emit("flash_fwd_train", shape="B=2 S=2048, causal, with the lse: llama3_8b "
         "H=32 KV=8 D=128, gemma2b H=8 KV=1 D=256", **train)
    # The families' prefill shapes: Gemma-2-2B's local layers (window 4096,
    # softcap 50) at S = 6144, where the window's lower edge skips tiles,
    # and Gemma-3-4B's (window 1024) at S = 2048; timed beside the plain
    # version and, without the cap, SDPA over the band.
    for prefix, args, kw in (
            ("gemma2_2b", ("gemma2-2b B1 S6144 window4096 softcap50", 1, 6144,
                           8, 4, 256), dict(window=4096, softcap=50.0)),
            ("gemma3_4b", ("gemma3-4b B1 S2048 window1024", 1, 2048, 8, 4, 256),
             dict(window=1024))):
        c = flash_case(*args, timed=True, **kw)
        train.update(bandwidth_fields(prefix, c))
        f.append(c)
    results["flash_fwd_extra"] = train
    d = results["paged_decode"]
    d.append(decode_case("gemma2b int8 bs128", 8, 8, 1, 256, 128, True, timed=True))
    d.append(decode_case("gemma2b bf16 bs128", 8, 8, 1, 256, 128, False))
    d.append(decode_case("gemma2b int8 bs16", 8, 8, 1, 256, 16, True))
    d.append(decode_case("gemma2b bf16 bs16", 8, 8, 1, 256, 16, False))
    tiles = {}
    for model, (H, KV, D) in (("gemma2b", (8, 1, 256)), ("llama3-8b", (32, 8, 128))):
        for bs in (16, 128):
            for quantized in (True, False):
                kind = "int8" if quantized else "bf16"
                # Timed extras (not the kernels line's case): the serving
                # shape at the paged pool's tile 16 against tile 128.
                timed = model == "gemma2b" and quantized
                c = decode_case(f"{model} {kind} bs{bs} dead lane", 8, H, KV, D,
                                bs, quantized, dead=True, timed=timed)
                if timed:
                    tiles[f"bs{bs}_ms"] = c.pop("ms")
                    for f in ("call_ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by"):
                        tiles[f"bs{bs}_{f}"] = c.pop(f)
                d.append(c)
                for SQ in (4, 8):
                    c = decode_mq_case(f"{model} {kind} bs{bs} SQ{SQ}", 8, H, KV,
                                       D, bs, quantized, SQ,
                                       timed=timed and SQ == 8 and bs == 16)
                    if "ms" in c:
                        tiles.update({f"sq8_bs16_{f}": c.pop(f) for f in (
                            "ms", "call_ms", "plain_ms", "library_ms",
                            "bound_ms", "bound_by")})
                    d.append(c)
    # Tiles of more keys than the split pass holds logits for at once: the
    # chunk is walked in pieces.
    for quantized in (True, False):
        kind = "int8" if quantized else "bf16"
        d.append(decode_mq_case(f"gemma2b {kind} bs1024 SQ4", 8, 8, 1, 256,
                                1024, quantized, 4, max_len=4096))
    # The bandwidth case: a working set past the L2 (~136 MB of int8 KV).
    c = decode_case("gemma2b int8 bs16 B64 pos4095", 64, 8, 1, 256, 16, True,
                    max_len=4096, timed=True, full=True)
    tiles.update(bandwidth_fields("bw_b64_pos4095", c))
    d.append(c)
    # Qwen2-7B's heads: 28 query heads over 4 KV heads, a group of 7.
    for bs in (16, 128):
        for quantized in (True, False):
            kind = "int8" if quantized else "bf16"
            timed = quantized and bs == 16
            c = decode_case(f"qwen2-7b {kind} bs{bs} dead lane", 8, 28, 4, 128,
                            bs, quantized, dead=True, timed=timed)
            if timed:
                tiles.update(bandwidth_fields("qwen2_g7_bs16", c))
            d.append(c)
            d.append(decode_mq_case(f"qwen2-7b {kind} bs{bs} SQ4", 8, 28, 4,
                                    128, bs, quantized, 4))
    emit("paged_decode_tiles", shape="B=8 H=8 KV=1 D=256 int8, max_len 2048, "
         "ragged pos, one dead lane; bw_: B=64, max_len 4096, every lane at "
         "4095, tile 16; qwen2_g7_: B=8 H=28 KV=4 D=128 int8, tile 16",
         **tiles)
    results["paged_decode_extra"] = tiles
    n = results["dense_decode"]
    for pos in (0, 127, 128, 1000, 2047):
        n.append(dense_case(f"gemma2b B8 S2048 pos{pos}", 8, 2048, 8, 1, 256, pos,
                            timed=pos == 2047))
    for pos in (5, 2047):
        n.append(dense_case(f"llama3-8b B8 S2048 pos{pos}", 8, 2048, 32, 8, 128,
                            pos))
    c = dense_case("gemma2b B32 S4096 pos4095", 32, 4096, 8, 1, 256, 4095,
                   timed=True)
    dense = bandwidth_fields("bw_b32_pos4095", c)
    n.append(c)
    n.append(dense_case("qwen2-7b B8 S2048 pos5", 8, 2048, 28, 4, 128, 5))
    c = dense_case("qwen2-7b B8 S2048 pos2047", 8, 2048, 28, 4, 128, 2047,
                   timed=True)
    dense.update(bandwidth_fields("qwen2_g7", c))
    n.append(c)
    emit("dense_decode_bandwidth", shape="B=32 S=4096 H=8 KV=1 D=256 bf16, "
         "pos 4095; qwen2_g7_: B=8 S=2048 H=28 KV=4 D=128, pos 2047", **dense)
    results["dense_decode_extra"] = dense
    bwd = [  # llama3-8b widths unless the case says otherwise
        bwd_case("llama3-8b train B2 S2048", 2, 2048, 32, 8, 128, timed=True),
        bwd_case("llama3-8b B1 S128", 1, 128, 32, 8, 128),
        bwd_case("llama3-8b B1 S256", 1, 256, 32, 8, 128),
        bwd_case("mqa H8 KV1", 2, 256, 8, 1, 128),
        bwd_case("non-causal", 2, 256, 8, 2, 128, causal=False),
        bwd_case("window64+softcap50", 2, 256, 8, 2, 128, window=64,
                 softcap=50.0),
        bwd_case("D64", 2, 256, 8, 2, 64),
        bwd_case("gemma-2b train B2 S2048", 2, 2048, 8, 1, 256, timed=True),
        bwd_case("gemma-7b heads H16 KV16", 2, 256, 16, 16, 256),
        bwd_case("D256 non-causal", 1, 160, 4, 2, 256, causal=False),
        bwd_case("D256 window96+softcap30", 1, 320, 4, 1, 256, window=96,
                 softcap=30.0),
    ]
    # The kernels line's timed case stays the Llama train shape; the Gemma-2B
    # train shape's times go beside it.
    gemma = {}
    for key in ("dq", "dkv"):
        r = bwd[7][key]
        gemma.update({f"gemma2b_{key}_{f}": r.pop(f) for f in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "delta_ms",
            "pair_with_delta_ms", "flash_backward_ms") if f in r})
    emit("flash_bwd_gemma2b", shape="B=2 S=2048 H=8 KV=1 D=256, causal", **gemma)
    results["flash_bwd_dq"] = [r["dq"] for r in bwd]
    results["flash_bwd_dkv"] = [r["dkv"] for r in bwd]
    results["flash_bwd_extra"] = {
        **{f"llama3_8b_{f}": bwd[0]["dq"][f] for f in (
            "delta_ms", "pair_with_delta_ms", "flash_backward_ms")}, **gemma}
    # K1: the ring's block pairs at Llama-3-8B's train shape (S_loc = 2048
    # of an 8192-token ring of 4), the full pair first (6 of a ring's 10
    # pairs; the kernels line's timed case), then the diagonal, then a
    # Gemma-2-2B local layer's windowed pair, whose last row sees no key.
    blocks = [
        block_case("llama3-8b full pair", 2048, 32, 8, 128, 6144, 0, timed=True),
        block_case("llama3-8b diagonal pair", 2048, 32, 8, 128, 4096, 4096,
                   timed=True),
        block_case("gemma2-2b window4096 softcap50 pair", 2048, 8, 4, 256, 4096,
                   0, window=4096, softcap=50.0, timed=True),
        block_case("gemma2-2b window unreached", 2048, 8, 4, 256, 6144, 0,
                   window=4096, softcap=50.0),
        block_case("D64 part tiles window", 320, 4, 2, 64, 640, 320, window=200),
    ]
    extra = {"full_dq_block_backward_ms": blocks[0][1].pop("block_backward_ms")}
    for prefix, rows in (("diagonal", blocks[1]), ("window", blocks[2])):
        for key, row in zip(("fwd", "dq", "dkv"), rows):
            extra.update({f"{prefix}_{key}_{k_}": row.pop(k_) for k_ in (
                "ms", "call_ms", "plain_ms", "library_ms", "library_note",
                "bound_ms", "bound_by", "block_backward_ms") if k_ in row})
    emit("flash_block_timing", shape="B=1 S=2048 per block: llama3_8b H=32 KV=8 "
         "D=128 (full pair q_off 6144 k_off 0 on the kernels line; diagonal at "
         "4096); window: gemma2_2b H=8 KV=4 D=256, window 4096, softcap 50, "
         "q_off 4096, k_off 0", **extra)
    results["flash_fwd_block"] = [b_[0] for b_ in blocks]
    results["flash_bwd_dq_block"] = [b_[1] for b_ in blocks]
    results["flash_bwd_dkv_block"] = [b_[2] for b_ in blocks]
    results["flash_block_extra"] = extra
    return results


KERNEL_CLASSES = ("paged_decode", "dense_decode", "flash_fwd", "flash_bwd_dq",
                  "flash_bwd_dkv")


def profiled(window: str, fn, **fields) -> None:
    """Run ``fn`` under ``torch.profiler`` and print where its device time
    goes: summed per class (this repository's kernels, cuBLAS GEMMs,
    everything else) and per kernel name, against the host wall."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "device_time_total", None) or e.cuda_time_total

    classes = dict.fromkeys(KERNEL_CLASSES + ("gemm", "other"), 0.0)
    for e in kernels:
        name = e.key.lower()
        cls = next((c for c in KERNEL_CLASSES if c in name), None) or (
            "gemm" if any(t in name for t in ("gemm", "gemv", "sm90", "cutlass",
                                               "cublas", "nvjet")) else "other")
        classes[cls] += dev_us(e) / 1e3
    busy = sum(classes.values())
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    emit("profile", window=window, **fields,
         wall_ms=round(wall * 1e3, 3), device_busy_ms=round(busy, 3),
         device_idle_share=round(1 - busy / (wall * 1e3), 4),
         by_class_ms={k: round(v, 3) for k, v in classes.items()},
         top=[{"kernel": e.key[:80], "ms": round(dev_us(e) / 1e3, 3),
               "count": e.count} for e in top])


def window_rounds(steps: int) -> int:
    """Rounds of a profiled decode window: at least 48 decode steps and
    two rounds, so that one round's host jitter weighs little."""
    return max(2, -(-48 // steps))


def profile_rounds(params, cfg, kw, rng, lanes: int = 8, model: str = "gemma_2b") -> dict:
    """Where a decode round's device time goes: ``lanes`` requests (prompts
    of 500-1000 tokens) admitted and two rounds run (the warm-up chunk,
    then the capture and the first replay), then :func:`window_rounds`
    more under the profiler, all graph replays. Budgets outlast the
    window."""
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    srv = GenerationServer(params, cfg, **kw)
    steps = srv.stats()["decode_steps"] * kw["chunk"]
    n_rounds = window_rounds(steps)
    for n in rng.integers(500, 1001, lanes):
        srv.submit(rng.integers(0, cfg.vocab_size, n), (n_rounds + 3) * steps)
    srv.step()  # admission of every request the server holds, and a chunk
    srv.step()
    busy = srv.stats()["lanes_busy_peak"]

    def rounds():
        for _ in range(n_rounds):
            srv.step()

    arena = (f"paged pool, tile {kw['kv_block_size']}" if "kv_pool_tokens" in kw
             else "slotted arena")
    loop = "overlapped" if srv.overlap else "lock-step"
    fields = dict(model=model, loop=loop,
                  decode_steps=srv.stats()["decode_steps"], lanes=busy,
                  rounds=n_rounds)
    profiled(f"{n_rounds} {loop} decode rounds ({n_rounds * steps} steps), "
             f"{arena}, {busy} of {kw['max_batch']} lanes busy, prompts "
             "500-1000", rounds, **fields)
    del srv
    return fields


def crosscheck(params, cfg, prompt, buckets, max_len: int,
               decode: bool = True) -> dict:
    """One request through the kernel path and the plain path.

    Inside the model, each layer's kernel call (prefill, then the first
    decode step) is held against the plain version on the same inputs —
    the main path's own shapes and strided layouts — with
    ``attention.kernel_tolerance``. End to end, the kernel path's
    last-position prefill logits and first decode step's logits are held
    against the plain path's, within LOGIT_BOUND x the plain logits' RMS;
    both decode steps start from the kernel path's caches, so the decode
    comparison sees only the decode attention. Greedy agreement over 16
    more steps is printed, not asserted: random weights make near-ties.
    ``decode=False`` (a config whose decode runs the plain attention on
    both paths) checks the prefill alone."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        _decode_scan,
        forward,
        prefill_batch,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import attention
    from kata_xpu_device_plugin_tpu_torch.ops.quant import dequantize_kv

    ref = attention.reference_attention
    kernel_fn = (attention.make_decode_attn_fn(cfg, arena_len=max_len,
                                               device="cuda") if decode else None)
    layer_checks = {"prefill": [], "decode": []}

    def checked_flash(q, k, v, **kw):
        out = attention.flash_attention(q, k, v, **kw)
        mag = ref(q.float(), k.float(), v.abs().float(), **kw)
        layer_checks["prefill"].append(check("layer", out, ref(q, k, v, **kw), mag))
        return out

    def checked_decode(q, ck, cv, tables, pos):
        out = kernel_fn(q, ck, cv, tables, pos)
        plain = ref(q, dequantize_kv(ck, q.dtype), dequantize_kv(cv, q.dtype),
                    q_offset=pos)
        mag = ref(q.float(), dequantize_kv(ck, torch.float32),
                  dequantize_kv(v_abs(cv), torch.float32), q_offset=pos)
        layer_checks["decode"].append(check("layer", out, plain, mag))
        return out

    n = len(prompt)
    pad = next(b for b in buckets if b >= n)
    toks = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    toks[0, :n] = torch.from_numpy(np.asarray(prompt, np.int32))
    tl = torch.tensor([n], dtype=torch.int32)
    ck, lk, pos = prefill_batch(params, toks, cfg, max_len, tl, attn_fn=checked_flash,
                                kv_quantized=True)
    _, lp, _ = prefill_batch(params, toks, cfg, max_len, tl, attn_fn=ref,
                             kv_quantized=True)
    _, la, _ = prefill_batch(params, toks, cfg, max_len, tl, attn_fn=plain_fp32_p,
                             kv_quantized=True)
    row = {"prompt_len": n, "logit_bound_x_rms": LOGIT_BOUND}
    compared = [("prefill", lk, lp, la)]
    if not decode:
        _compare(row, compared, layer_checks)
        emit("crosscheck", **row)
        return row
    first = torch.argmax(lk, -1).to(torch.int32)

    def step(caches, fn, attn_fn=ref):
        logits, _ = forward(params, first[:, None], cfg, attn_fn=attn_fn,
                            positions=pos[:, None], kv_caches=caches,
                            cache_offset=pos, decode_kernel_fn=fn)
        return logits[:, -1]

    cd = tuple(type(c)(*(t.clone() for t in c)) for c in ck)
    ca = tuple(type(c)(*(t.clone() for t in c)) for c in ck)
    dk, dp = step(ck, checked_decode), step(cd, None)
    da = step(ca, None, plain_fp32_p)
    nxt = torch.argmax(dk, -1).to(torch.int32)
    gk = _decode_scan(params, ck, nxt, pos + 1, cfg, 16, attn_fn=ref,
                      decode_kernel_fn=kernel_fn)
    gp = _decode_scan(params, cd, nxt, pos + 1, cfg, 16, attn_fn=ref)
    _compare(row, compared + [("decode", dk, dp, da)], layer_checks)
    row["greedy_agreement_16"] = float((gk == gp).float().mean())
    emit("crosscheck", **row)
    return row


def plain_fp32_p(q, k, v, **kw):
    """The plain attention with its probabilities kept in fp32 (the plain
    version rounds them to bf16 before the P.V product): an equally valid
    bf16 attention, whose distance from the plain path's logits is the
    noise floor that the model's depth makes of rounding alone."""
    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention

    return reference_attention(q.float(), k.float(), v.float(), **kw).to(q.dtype)


def _compare(row: dict, compared, layer_checks) -> None:
    for what, got, want, alt in compared:
        cases = layer_checks[what]
        row[f"{what}_layers_checked"] = len(cases)
        row[f"{what}_layer_max_err_over_bound"] = max(
            c["max_err_over_bound"] for c in cases)
        row[f"{what}_logit_err"] = float((got - want).abs().max())
        row[f"{what}_logit_rms"] = float(want.square().mean().sqrt())
        row[f"{what}_noise_err"] = float((alt - want).abs().max())


def assert_family_crosscheck(row: dict, n_layers: int) -> None:
    """Every layer's kernel call checked (within ``kernel_tolerance``, by
    :func:`check`), and the logits within the serving bound or within
    :data:`NOISE_FACTOR` x the run's noise floor; which held is recorded."""
    for what in ("prefill", "decode"):
        if f"{what}_layers_checked" not in row:
            continue
        if row[f"{what}_layers_checked"] != n_layers:
            raise AssertionError(f"{what}: {row[f'{what}_layers_checked']} layer "
                                 f"checks, want {n_layers}")
        err, rms = row[f"{what}_logit_err"], row[f"{what}_logit_rms"]
        noise = row[f"{what}_noise_err"]
        row[f"{what}_within_serving_bound"] = err <= LOGIT_BOUND[what] * rms
        row[f"{what}_err_over_noise"] = err / noise if noise else math.inf
        if not math.isfinite(err) or not (row[f"{what}_within_serving_bound"]
                                          or err <= NOISE_FACTOR * noise):
            raise AssertionError(f"{what} logits: kernel vs plain {row}")


def assert_crosscheck(row: dict, n_layers: int) -> None:
    for what in ("prefill", "decode"):
        if f"{what}_layers_checked" not in row:
            continue  # a prefill-only crosscheck
        if row[f"{what}_layers_checked"] != n_layers:
            raise AssertionError(f"{what}: {row[f'{what}_layers_checked']} layer "
                                 f"checks, want {n_layers}")
        err, rms = row[f"{what}_logit_err"], row[f"{what}_logit_rms"]
        if not math.isfinite(err) or err > LOGIT_BOUND[what] * rms:
            raise AssertionError(f"{what} logits: kernel vs plain {row}")


SERVE_KW = dict(max_len=2048, prefill_buckets=(128, 256, 512, 1024), chunk=8)
# The paged phase's pool. The requests below never press a pool of 8192
# tokens into preempting (admission reserves whole prefill buckets, which
# already cover most requests' budgets); scripts/torch_paged_pool_scan.py
# replays the schedule on the CPU, and 8000 tokens (498 usable blocks of
# 16) is the size nearest 8192 at which growth runs the pool dry: three
# preemptions, twelve lanes at once.
PAGED_KW = dict(max_batch=16, kv_pool_tokens=8000, kv_block_size=16)


def gemma_setup(seed: int = 0, model: str = "gemma_2b"):
    """Full-width Gemma-2B (or ``model``, a config of the port's
    ``models``), random bf16 weights from ``seed``, fused."""
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.models import fuse_decoder_params, init_params

    cfg = getattr(models, model)()
    t0 = time.perf_counter()
    params = fuse_decoder_params(
        init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"],
                                       *params["layers"].values()])
    emit("serve_setup", model=model, params=n_params,
         init_s=round(time.perf_counter() - t0, 3))
    return params, cfg


# Counters of stats() that run_requests reports for its timed run alone.
RUN_COUNTERS = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
                "preemptions", "decode_graph_replays", "prefix_hits",
                "prefix_misses", "prefix_tokens_reused", "cow_copies",
                "kv_demotions", "kv_prefetches", "kv_resume_staged")


def warm_server(srv) -> dict:
    """One short request through ``srv`` before it is timed, long enough
    for two dispatches: the server's eager warm-up chunk and its capture
    are one-time costs of a server (``decode_graph`` prints the capture's),
    not part of what its users wait for in a run. The latency summaries
    start afresh after it. Returns the stats after it."""
    import numpy as np

    from kata_xpu_device_plugin_tpu_torch.obs.metrics import Rolling

    steps = srv.stats()["decode_steps"] * srv.chunk
    srv.submit(np.arange(1, 101, dtype=np.int32), steps + 2)
    srv.run()
    srv._ttft, srv._tok_lat = Rolling(), Rolling()
    return srv.stats()


def counted_kernels() -> dict:
    """The serving kernels' wrappers whose launches a phase counts, by
    their names in the kernels line."""
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        decode_attention,
        paged_decode_attention,
        paged_decode_shard_stats,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward

    return {"flash_fwd": flash_forward, "paged_decode": paged_decode_attention,
            "paged_decode_shard": paged_decode_shard_stats,
            "dense_decode": decode_attention}


def run_requests(srv, prompts, budgets, waves=None, after_warm=None):
    """Warm the server (:func:`warm_server`), submit every request, reset
    the serving kernels' launch counts, drain the server, read the counts.
    ``after_warm()``, when given, runs between the warm-up and the timed
    run (the telemetry phase marks its event stream there).
    ``waves``: the requests' split into waves, each submitted when the one
    before it has been served to its end (default: one wave). Returns the
    outputs in submit order, the wall time, the launches and the server's
    stats, with :data:`RUN_COUNTERS` counted over this run alone; every
    request must return its budget of in-vocabulary tokens. A server whose
    decode runs the plain attention (by its config's rule) must launch the
    flash kernel and no decode kernel."""
    import torch

    kernels = counted_kernels()
    base = warm_server(srv)
    if after_warm is not None:
        after_warm()
    waves = list(waves or (len(prompts),))
    rids = [srv.submit(p, int(b)) for p, b in zip(prompts[:waves[0]],
                                                  budgets[:waves[0]])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = srv.run()
    at = waves[0]
    for n in waves[1:]:
        rids += [srv.submit(p, int(b)) for p, b in zip(prompts[at:at + n],
                                                       budgets[at:at + n])]
        results.update(srv.run())
        at += n
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    life = srv.stats()
    stats = {**life, **{k: life[k] - base[k] for k in RUN_COUNTERS}}
    outs = [results[rid] for rid in rids]
    for rid, out, b in zip(rids, outs, budgets):
        if len(out) != int(b):
            raise AssertionError(f"request {rid}: {len(out)} tokens, budget {b}")
        if not ((out >= 0) & (out < srv.cfg.vocab_size)).all():
            raise AssertionError(f"request {rid}: token out of vocabulary")
    kernel = stats["decode_backend"] == "cuda_paged"
    # A tensor-parallel server launches the decode kernel once a shard; under
    # the blocks layout in its shard-local form.
    decode = "paged_decode_shard" if stats["kv_pool_shards"] > 1 else "paged_decode"
    want = {"flash_fwd", decode} if kernel else {"flash_fwd"}
    if set(launches) != want:
        raise AssertionError(f"serving ({stats['decode_backend']} decode) must "
                             f"launch {sorted(want)} and no other: {launches}")
    rounds, steps = stats["rounds"], stats["decode_steps"] * srv.chunk
    per_round = steps * srv.cfg.n_layers * stats["tp_degree"]
    if kernel and launches[decode] != rounds * per_round:
        raise AssertionError(f"a decode step left the paged kernel: {launches}, "
                             f"{rounds} rounds of {steps} steps, "
                             f"{stats['tp_degree']} shards")
    if (life["decode_graph_captures"] != 1
            or life["decode_graph_replays"] != life["rounds"] - 1
            or stats["decode_graph_replays"] != rounds):
        raise AssertionError(f"every chunk after the warm-up must be a graph "
                             f"replay: {life}")
    return outs, wall, launches, stats


def serve_row(stats, wall, budgets, lens, launches) -> dict:
    import torch

    generated = int(sum(budgets))
    return dict(
        requests=len(budgets), prompt_tokens=int(sum(lens)),
        generated_tokens=generated, wall_s=round(wall, 4),
        tok_s=round(generated / wall, 2),
        ttft_p50_s=stats["ttft_s"]["p50"], ttft_p99_s=stats["ttft_s"]["p99"],
        itl_p50_s=stats["decode_token_s"]["p50"],
        itl_p99_s=stats["decode_token_s"]["p99"],
        rounds=stats["rounds"], prefills=stats["prefills"],
        prefill_batches=stats["prefill_batches"],
        decode_steps=stats["decode_steps"],
        decode_graph={k: stats[f"decode_graph_{k}"] for k in (
            "captures", "replays", "capture_s", "pool_bytes")},
        arena_bytes=stats["arena_bytes"],
        peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=launches)


SIDE_KEYS = ("tok_s", "wall_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
             "itl_p99_s", "rounds", "prefill_batches", "decode_steps",
             "decode_graph", "launches")


def _bits(t):
    """A tensor's bytes as integers, so that equality is bit equality."""
    import torch

    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def graph_check(params, cfg, kw, seed: int = 0, budget: int = 64) -> dict:
    """One decode chunk by CUDA graph against the same chunk run eagerly:
    a server with ``kw`` admits 8 requests of ``budget`` tokens (more
    than a chunk's steps, so lanes live on into the second chunk) and
    decodes its warm-up chunk
    (lock-step), then the second chunk is run eagerly on a clone of the
    arena and through the server's graph (its capture, then its first
    replay) on the live arena, from the same inputs. Tokens, ``last``,
    ``pos`` and every byte of the arena must be equal (a sampled or MoE
    paged server's scratch block aside: below). A sampling server's
    generator is set back (``get_state``/``set_state``) to its state before
    the eager chunk ahead of each replay, so the replay draws the same
    numbers; one more replay without that must draw fresh ones."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import serve_decode
    from kata_xpu_device_plugin_tpu_torch.guest.kv_arena import SCRATCH_BLOCK
    from kata_xpu_device_plugin_tpu_torch.ops.quant import QTensor

    srv = GenerationServer(params, cfg, **{**kw, "overlap": False})
    rng = np.random.default_rng(seed)
    for n in rng.integers(64, 1001, 8):
        srv.submit(rng.integers(0, cfg.vocab_size, n), budget)
    srv.step()
    srv._ensure_blocks()
    arena = srv.kv_pool.arena if srv.paged else srv.arena
    leaves = [t for c in arena for t in (c if isinstance(c, QTensor) else (c,))]
    clone = [t.clone() for t in leaves]
    it = iter(clone)
    eager_arena = tuple(type(c)(*(next(it) for _ in c)) if isinstance(c, QTensor)
                        else next(it) for c in arena)

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to("cuda")

    extra = {}
    if srv._decode_steps > 1:
        extra["budget"] = dev(srv._decode_budget())
    if srv.paged:
        extra["block_tables"] = dev(srv._bt_host)
    exe = srv._decode
    tok, pos = dev(srv._last), dev(srv._pos)
    gen = srv.generator if srv._do_sample else None
    state = gen.get_state() if gen is not None else None

    def restore():
        if gen is not None:
            gen.set_state(state)

    t0 = time.perf_counter()
    want = serve_decode(srv.params, eager_arena, tok, pos, cfg, exe.steps,
                        exe.decode_kernel_fn, **extra, **exe._kw)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    restore()
    got = exe(tok, pos, **extra)
    torch.cuda.synchronize()
    first = [t.clone() for t in got]
    restore()
    t0 = time.perf_counter()
    exe(tok, pos, **extra)  # a second replay, timed (it rewrites the same rows)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    outs_equal = all(torch.equal(g, w) for g, w in zip(first, want)) and all(
        torch.equal(g, w) for g, w in zip(got, want))
    # The second replay rewrote the rows the first wrote, with equal values.
    # A paged server's dead lanes all write the scratch block, which nothing
    # reads: greedy, they write equal values there; sampled, each draws its
    # own tokens, and in an MoE model they compete for expert capacity
    # (some of their copies are dropped, some not), so their k/v differ and
    # which of the duplicate writes lands is not fixed. A sampled or MoE
    # paged check holds every byte but the scratch block's.
    scratch = None
    if (gen is not None or cfg.moe) and srv.paged:
        bs = srv.kv_block
        scratch = slice(SCRATCH_BLOCK * bs, (SCRATCH_BLOCK + 1) * bs)
        scratch_equal = all(torch.equal(_bits(a[:, :, scratch]),
                                        _bits(c[:, :, scratch]))
                            for a, c in zip(leaves, clone))
        for a, c in zip(leaves, clone):
            c[:, :, scratch] = a[:, :, scratch]
    arena_equal = all(torch.equal(_bits(a), _bits(c)) for a, c in zip(leaves, clone))
    fresh = None
    if gen is not None:  # no restore: the generator has moved on
        fresh = not torch.equal(exe(tok, pos, **extra)[0], first[0])
    row = dict(arena="paged" if srv.paged else "slotted",
               tp=srv.stats()["tp_degree"], kv_layout=srv.stats()["kv_layout"],
               sampled=gen is not None, fresh_draws_without_restore=fresh,
               scratch_block_bit_equal=None if scratch is None else scratch_equal,
               kv_quant=srv.stats()["kv_quant"], steps=exe.steps,
               lanes=sum(r is not None for r in srv._slot_req),
               outputs_bit_equal=outs_equal, arena_bit_equal=arena_equal,
               arena_bytes_compared=sum(t.numel() * t.element_size() for t in leaves),
               captures=exe.captures, replays=exe.replays,
               capture_s=round(exe.capture_s, 4), graph_pool_bytes=exe.pool_bytes,
               eager_chunk_s=round(eager_s, 6), replay_chunk_s=round(replay_s, 6))
    emit("graph_check", **row)
    replays = 3 if gen is not None else 2
    if (not (outs_equal and arena_equal) or fresh is False
            or (exe.captures, exe.replays) != (1, replays)):
        raise AssertionError(f"graph replay differs from the eager chunk: {row}")
    return row


def phase_serve(params, cfg, seed: int = 0, profile: bool = False) -> dict:
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    kw = dict(max_batch=8, **SERVE_KW)
    rng = np.random.default_rng(seed)
    rng.integers(0, cfg.vocab_size, 100)  # skipped: the requests stay those PERF.md records

    lens = rng.integers(64, 1001, 16)
    budgets = rng.integers(64, 129, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    mem0 = torch.cuda.memory_allocated()
    srv = GenerationServer(params, cfg, **kw)
    outs, wall, launches, stats = run_requests(srv, prompts, budgets)
    if (stats["decode_backend"] != attention.BACKEND_PAGED
            or stats["kv_quant"] != "int8" or not srv.overlap):
        raise AssertionError(f"unexpected server mode: {stats}")
    row = serve_row(stats, wall, budgets, lens, launches)
    del srv
    lock = GenerationServer(params, cfg, overlap=False, **kw)
    outs_l, wall_l, launches_l, stats_l = run_requests(lock, prompts, budgets)
    del lock
    # The arenas and the graphs' pools go with their servers.
    torch.cuda.synchronize()
    emit("serve", loop="overlapped", **row,
         allocated_after_servers_freed_bytes=torch.cuda.memory_allocated() - mem0,
         lockstep_same_requests={k: v for k, v in serve_row(
             stats_l, wall_l, budgets, lens, launches_l).items() if k in SIDE_KEYS},
         token_match_vs_lockstep=token_match(outs, outs_l, budgets))
    graph_check(params, cfg, kw)

    rows = [crosscheck(params, cfg, prompts[i], kw["prefill_buckets"], kw["max_len"])
            for i in (0, 1)]
    for row in rows:
        assert_crosscheck(row, cfg.n_layers)
    if profile:
        for overlap in (True, False):
            profile_rounds(params, cfg, dict(kw, overlap=overlap), rng)
    return launches


def paged_crosscheck(params, cfg, prompts, budgets) -> dict:
    """One decode round of a loaded paged server with every layer's kernel
    call held against the plain version on its own inputs: the pool, the
    lanes' real (scattered, SCRATCH-filled, remapped) tables and positions
    exactly as the scheduler hands them over, dead lanes included."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import paged_decode_reference

    srv = GenerationServer(params, cfg, **PAGED_KW, **SERVE_KW)
    for p, b in zip(prompts, budgets):
        srv.submit(p, int(b))
    kernel_fn, cases = srv._decode.decode_kernel_fn, []
    kw = dict(block_size=PAGED_KW["kv_block_size"], paged_len=SERVE_KW["max_len"])

    def checked(q, ck, cv, tables, pos, q_lens=None):
        out = kernel_fn(q, ck, cv, tables, pos, q_lens)
        ref = paged_decode_reference(q, ck, cv, tables, pos, q_lens, **kw)
        mag = paged_decode_reference(q.float(), ck, v_abs(cv), tables, pos,
                                     q_lens, **kw)
        cases.append(check("paged layer", out, ref, mag))
        return out

    srv._decode.decode_kernel_fn = checked
    srv.step()  # admission of the first lanes, then the eager warm-up chunk
    torch.cuda.synchronize()
    want = cfg.n_layers * SERVE_KW["chunk"]
    stats = srv.stats()
    row = {"kernel_calls_checked": len(cases), "lanes": stats["lanes_busy_peak"],
           "kv_blocks_in_use": stats["kv_blocks_in_use"],
           "max_err_over_bound": max(c["max_err_over_bound"] for c in cases),
           "max_abs_err": max(c["max_abs_err"] for c in cases)}
    emit("paged_crosscheck", **row)
    if len(cases) != want or row["lanes"] < 2:
        raise AssertionError(f"paged crosscheck: {row}, want {want} checks")
    return row


def token_match(outs, other, budgets) -> dict:
    same = sum(int((a == b).sum()) for a, b in zip(outs, other))
    return {"tokens": same / int(sum(budgets)),
            "requests_identical": sum(bool((a == b).all())
                                      for a, b in zip(outs, other))}


def phase_paged(params, cfg, seed: int = 0, profile: bool = False) -> dict:
    """32 requests over the paged pool (the default, overlapped loop), then
    the same requests through the lock-step paged server and the paged
    server at ``decode_steps=4``, then over the slotted arena for the
    token-match fraction (printed, not asserted: the two servers batch
    differently, cuBLAS may pick another kernel per batch size, the tiles
    differ, and random weights turn one differing rounding into another
    continuation). A last run puts the fraction in proportion: a paged
    server with the slotted server's lane count and KV tile (8 lanes, tile
    128, a pool that never presses) does the slotted server's arithmetic
    through scattered tables."""
    import numpy as np

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1001, 32)
    budgets = rng.integers(64, 129, 32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    srv = GenerationServer(params, cfg, **PAGED_KW, **SERVE_KW)
    outs, wall, launches, stats = run_requests(srv, prompts, budgets)
    row = serve_row(stats, wall, budgets, lens, launches)
    row.update({k: stats[k] for k in (
        "preemptions", "preempted_waiting", "kv_blocks_in_use", "kv_blocks_total",
        "kv_pool_tokens", "kv_pool_occupancy_peak", "lanes_busy_peak")})
    del srv
    sides = {}
    for name, extra in (("lockstep", dict(overlap=False)),
                        ("decode_steps_4", dict(decode_steps=4))):
        side = GenerationServer(params, cfg, **PAGED_KW, **SERVE_KW, **extra)
        outs_x, wall_x, launches_x, stats_x = run_requests(side, prompts, budgets)
        del side
        sides[name] = {
            **{k: v for k, v in serve_row(stats_x, wall_x, budgets, lens,
                                          launches_x).items() if k in SIDE_KEYS},
            "preemptions": stats_x["preemptions"],
            "token_match_vs_default": token_match(outs_x, outs, budgets)}
    graph_check(params, cfg, dict(**PAGED_KW, **SERVE_KW))
    slotted = GenerationServer(params, cfg, max_batch=8, **SERVE_KW)
    outs_s, wall_s, launches_s, stats_s = run_requests(slotted, prompts, budgets)
    slotted_row = serve_row(stats_s, wall_s, budgets, lens, launches_s)
    del slotted
    twin_kw = dict(max_batch=8, kv_pool_tokens=8 * 2048 + 2 * 128,
                   kv_block_size=128)
    twin = GenerationServer(params, cfg, **twin_kw, **SERVE_KW)
    outs_t, wall_t, _, stats_t = run_requests(twin, prompts, budgets)
    del twin
    emit("paged", config=PAGED_KW, loop="overlapped", **row,
         token_match_vs_slotted=token_match(outs, outs_s, budgets),
         **{f"{k}_same_requests": v for k, v in sides.items()},
         slotted_same_requests={k: slotted_row[k] for k in (
             "tok_s", "wall_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
             "itl_p99_s", "rounds", "arena_bytes", "launches")},
         same_tile_and_lanes=dict(
             config=twin_kw, tok_s=round(int(sum(budgets)) / wall_t, 2),
             rounds=stats_t["rounds"], preemptions=stats_t["preemptions"],
             token_match_vs_slotted=token_match(outs_t, outs_s, budgets)))
    if (stats["decode_backend"] != attention.BACKEND_PAGED
            or stats["kv_quant"] != "int8"):
        raise AssertionError(f"unexpected server mode: {stats}")
    if stats["preemptions"] < 1:
        raise AssertionError("the pool never came under pressure: no preemption")
    if stats["kv_blocks_in_use"] or stats["preempted_waiting"]:
        raise AssertionError(f"the pool did not drain: {stats}")
    if stats["lanes_busy_peak"] <= 8:
        raise AssertionError(f"peak lanes {stats['lanes_busy_peak']}: no more "
                             "than the slotted grid")
    paged_crosscheck(params, cfg, prompts[:12], budgets[:12])
    if profile:
        for overlap in (True, False):
            profile_rounds(params, cfg, dict(**PAGED_KW, **SERVE_KW, overlap=overlap),
                           rng, lanes=16)
    return launches


# ----- telemetry ---------------------------------------------------------------

TELEMETRY_DIR = os.path.join(HERE, "build", "telemetry")
# The heartbeat fields tools/obs_report.py's report and the daemon's
# HeartbeatAggregator read, and the request_trace fields the report's
# schema gate requires.
HEARTBEAT_FIELDS = ("round", "interval_rounds", "interval_s", "tokens_per_s",
                    "itl_p99_ms", "batch_occupancy", "kv_pool_occupancy",
                    "kv_host_occupancy", "queued", "chips", "mfu",
                    "device_busy_frac", "dispatch_gap_ms", "dispatches_delta",
                    "phase_admit_s", "phase_dispatch_s", "phase_retire_s",
                    "phase_host_transfer_s", "phase_other_s")
HBM_FIELDS = ("hbm_used_bytes", "hbm_peak_bytes", "hbm_limit_bytes",
              "hbm_headroom_bytes", "hbm_params_bytes", "hbm_kv_arena_bytes",
              "hbm_attributed_bytes", "hbm_unattributed_bytes")
TRACE_PHASES = ("queue", "prefill", "decode", "decode_degraded", "preempted",
                "recovery")


def decode_round_flops(cfg, lanes: int, steps: int, keys: float) -> float:
    """This script's own count of a decode round's FLOPs (the bench
    convention of :func:`train_flops_per_step`): 2 x matmul parameters x
    the tokens of every lane the chunk computes, plus QK^T and PV, 4 x H x
    D a key, over ``keys`` keys a row, in every layer."""
    per_layer = (cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
                 + cfg.q_dim * cfg.d_model + 3 * cfg.d_model * cfg.d_ff)
    matmul = cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size
    attn = 4 * cfg.n_heads * cfg.head_dim * cfg.n_layers * keys
    return lanes * steps * (2.0 * matmul + attn)


def check_stream(events, server: str, n_requests: int) -> dict:
    """The checks ``tools/obs_report.py --check`` makes on a stream, on this
    server's events: heartbeats with the fields the report and the daemon's
    aggregator read, one ``request_trace`` a request with its phases,
    spans with durations. Returns the heartbeats and traces."""
    mine = [e for e in events if e.get("server") == server]
    hbs = [e for e in mine if e["name"] == "serving_heartbeat"]
    traces = [e for e in mine if e["name"] == "request_trace"]
    spans = [e for e in events if e.get("kind") == "span"
             and e["name"].startswith("serving.")]
    missing = sorted({k for hb in hbs for k in HEARTBEAT_FIELDS if k not in hb})
    if not hbs or missing:
        raise AssertionError(f"heartbeats {len(hbs)}, missing fields {missing}")
    if len(traces) != n_requests or len({t["rid"] for t in traces}) != n_requests:
        raise AssertionError(f"{len(traces)} request traces for {n_requests}")
    for t in traces:
        for k in ("rid", "outcome", "wall_s", "tokens",
                  *(f"{p}_s" for p in TRACE_PHASES)):
            if k not in t:
                raise AssertionError(f"request_trace without {k}: {t}")
    if not spans or any("dur_s" not in e for e in spans):
        raise AssertionError("serving spans missing or without dur_s")
    return {"heartbeats": hbs, "traces": traces}


def telemetry_drills(params, cfg, prompts, budgets) -> dict:
    """The watchdog, strict-mode and profiler drills and the instrumented
    ``fit`` (module doc, phase 5a). Returns the fit's kernel launches."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import models, obs
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.ops import flash
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        TokenBatchLoader,
        fit,
        make_optimizer,
        make_train_step,
    )

    small = dict(PAGED_KW, max_batch=4, **SERVE_KW)
    # Watchdog: an ITL budget no round meets, judged every heartbeat.
    slo_ms = 1e-3
    wd = obs.SLOBurnWatchdog(obs.WatchdogConfig(slo_ms=slo_ms, window=2,
                                                sustain=1, clear=1))
    srv = GenerationServer(params, cfg, heartbeat_rounds=2, watchdog=wd, **small)
    for p, b in zip(prompts[:4], budgets[:4]):
        srv.submit(p, 24)
    srv.run()
    st = srv.stats()
    dump = st["watchdog"]["last_dump"]
    if not st["watchdog_alerts"] or not dump or not os.path.exists(dump):
        raise AssertionError(f"the watchdog drill left no dump: {st['watchdog']}")
    dumped = obs.read_events(dump)
    breach = [e for e in dumped if e["name"] == "serving_heartbeat"
              and e["itl_p99_ms"] > slo_ms]
    if not breach:
        raise AssertionError(f"the flight dump {dump} holds no breaching heartbeat")
    del srv
    # Strict mode's negative control: a host read of the card injected into
    # the guarded round must raise, and say so on the stream.
    srv = GenerationServer(params, cfg, strict=True, **small)
    real = srv._dispatch_decode

    def with_sync(tok, pos):
        torch.ones(1, device="cuda").sum().item()
        return real(tok, pos)

    srv._dispatch_decode = with_sync
    srv.submit(prompts[0], 8)
    mark = os.path.getsize(obs.default_sink().path)
    try:
        srv.run()
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
        tripped = str(exc).splitlines()[0][:120]
    else:
        raise AssertionError("strict mode let a sync in the guarded round pass")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("strict mode left the sync guard on")
    trips = [e for e in obs.read_events(obs.default_sink().path, mark)
             if e["name"] == "guard_trip"]
    if len(trips) != 1:
        raise AssertionError(f"guard_trip events {trips}")
    del srv
    # fit, 2 steps at Llama-3-8B widths with 2 layers, in train.step spans,
    # with a profiler window (KATATPU_OBS_PROFILE_*) over its second step.
    prof_dir = os.path.join(TELEMETRY_DIR, "profile")
    os.environ.update(KATATPU_OBS_PROFILE_DIR=prof_dir,
                      KATATPU_OBS_PROFILE_START="2",
                      KATATPU_OBS_PROFILE_STEPS="1")
    tcfg = models.llama3_8b(n_layers=2)
    stream = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                               2048).astype(np.int32)
    init_state, step = make_train_step(tcfg, make_optimizer())
    kernels = (flash.flash_forward, flash.flash_bwd_dq, flash.flash_bwd_dkv)
    for fn in kernels:
        fn.launches = 0
    mark = os.path.getsize(obs.default_sink().path)
    try:
        state, losses = fit(init_state, step, TokenBatchLoader(
            stream, batch=1, seq_len=2047, shuffle=False), steps=2)
    finally:
        for k in ("DIR", "START", "STEPS"):
            os.environ.pop(f"KATATPU_OBS_PROFILE_{k}")
    launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                        (fn.launches for fn in kernels)))
    del state
    evs = obs.read_events(obs.default_sink().path, mark)
    steps = [e for e in evs if e["name"] == "train.step"]
    traces = [e for e in evs if e["name"] == "torch_trace"]
    if ([e["step"] for e in steps] != [1, 2]
            or not all(math.isfinite(e["loss"]) and e["dur_s"] > 0 for e in steps)
            or [e["loss"] for e in steps] != [round(x, 6) for x in losses]):
        raise AssertionError(f"train.step spans {steps} for losses {losses}")
    if len(traces) != 1 or not os.path.getsize(traces[0]["path"]):
        raise AssertionError(f"the profiler window wrote no trace: {traces}")
    if any(n != 2 * tcfg.n_layers for n in launches.values()):
        raise AssertionError(f"fit launches {launches}")
    return dict(
        launches=launches,
        watchdog=dict(alerts=st["watchdog_alerts"], active=st["watchdog"]["active"],
                      dump=os.path.relpath(dump, HERE),
                      breaching_heartbeats_in_dump=len(breach)),
        strict_trip=tripped,
        fit=dict(model="llama3_8b", n_layers=2, B=1, S=2048,
                 step_s=[e["dur_s"] for e in steps], losses=losses,
                 trace=os.path.relpath(traces[0]["path"], HERE),
                 trace_bytes=os.path.getsize(traces[0]["path"])))


def phase_telemetry(params, cfg, smi: str) -> dict:
    """Phase 5a: the paged phase's configuration and 32 requests through two
    servers, in turns twice: **off** (``heartbeat_rounds=0``, no tripwire,
    no strict) and **on** (the defaults: heartbeat every 32 rounds, the
    device ledger and the watchdog armed, the tripwire; plus
    ``strict=True``), every event of the run into a sink under
    ``build/telemetry/``. Asserted: equal tokens, paged launches = rounds x
    chunk x K x layers, the heartbeat count of the cadence and the final
    flush, ``0 < mfu <= 1`` and ``0 < device_busy_frac <= 1`` on every
    heartbeat, the ledger's FLOPs over the run within 25% of this script's
    own count (:func:`decode_round_flops`), the ``hbm_*`` fields with at
    least the params' and the pool's bytes attributed, no compile and no
    new capture in the on server's second run, one ``request_trace`` a
    request whose phases sum to its wall time within 5%, and the stream's
    fields for ``tools/obs_report.py`` (:func:`check_stream`; the stream
    is copied to ``chiprun_out/`` where that directory exists). Then the
    drills (:func:`telemetry_drills`). Printed: tok/s off and on and the
    cost of telemetry, with the card's name and power limit."""
    import shutil

    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import obs

    shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    os.makedirs(TELEMETRY_DIR)
    prev_flight = os.environ.get("KATATPU_FLIGHT_DIR")
    os.environ["KATATPU_FLIGHT_DIR"] = os.path.join(TELEMETRY_DIR, "flight")
    sink_path = os.path.join(TELEMETRY_DIR, "events.jsonl")
    sink = obs.EventSink(sink_path)
    prev_sink = obs.set_default_sink(sink)
    prompts, budgets, lens = phase_requests(32, cfg.vocab_size)
    kw = dict(**PAGED_KW, **SERVE_KW)
    try:
        from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

        servers = {
            "off": GenerationServer(params, cfg, heartbeat_rounds=0,
                                    tripwire=False, strict=False, **kw),
            "on": GenerationServer(params, cfg, strict=True, **kw)}
        on = servers["on"]
        if (on._hb_every, on._watchdog is None, on._devledger.armed,
                on.tripwire) != (32, False, True, True):
            raise AssertionError("the default server did not arm the heartbeat, "
                                 "the ledger, the watchdog and the tripwire")
        runs, launches = [], {}
        for turn in range(2):
            for name, srv in servers.items():
                mark = {}
                outs, wall, ln, stats = run_requests(
                    srv, prompts, budgets, after_warm=lambda m=mark, s=srv: m.update(
                        offset=os.path.getsize(sink_path), stats=s.stats()))
                for k, n in ln.items():
                    launches[k] = launches.get(k, 0) + n
                runs.append(dict(name=name, turn=turn, outs=outs, wall=wall,
                                 stats=stats, before=mark["stats"],
                                 events=obs.read_events(sink_path, mark["offset"])))
        peak = on._devledger.peak_flops()
        rows = []
        for run in runs:
            st, before = run["stats"], run["before"]
            tok_s = float(sum(budgets)) / run["wall"]
            row = dict(server=run["name"], turn=run["turn"], tok_s=round(tok_s, 2),
                       wall_s=round(run["wall"], 4), rounds=st["rounds"],
                       heartbeats=st["heartbeats"] - before["heartbeats"])
            if run["name"] == "on":
                got = check_stream(run["events"], on._label, len(prompts))
                hbs = got["heartbeats"]
                want_hb = -(-st["rounds"] // 32)
                if len(hbs) != want_hb or row["heartbeats"] != want_hb:
                    raise AssertionError(f"{len(hbs)} heartbeats for {st['rounds']} "
                                         f"rounds at cadence 32 (want {want_hb})")
                for hb in hbs:
                    if not (0 < hb["mfu"] <= 1 and 0 < hb["device_busy_frac"] <= 1):
                        raise AssertionError(f"heartbeat out of range: {hb}")
                    absent = [k for k in HBM_FIELDS if k not in hb]
                    if absent:
                        raise AssertionError(f"heartbeat without {absent}")
                ledger = sum(hb["mfu"] * hb["interval_s"] for hb in hbs) * peak
                keys = float(np.mean(lens + budgets / 2))
                ours = st["rounds"] * decode_round_flops(
                    cfg, kw["max_batch"], st["decode_steps"] * on.chunk, keys)
                if abs(ledger - ours) > 0.25 * ours:
                    raise AssertionError(f"ledger FLOPs {ledger:.4g} against this "
                                         f"script's {ours:.4g}")
                owned = sum(t.numel() * t.element_size() for t in
                            [params["embed"], params["final_norm"],
                             *params["layers"].values()])
                owned += sum(t.numel() * t.element_size() for c in on.kv_pool.arena
                             for t in (c if isinstance(c, tuple) else (c,)))
                last = hbs[-1]
                if last["hbm_attributed_bytes"] < owned:
                    raise AssertionError(f"attributed {last['hbm_attributed_bytes']} "
                                         f"< params + pool {owned}")
                for t in got["traces"]:
                    total = sum(t[f"{p}_s"] for p in TRACE_PHASES)
                    if abs(total - t["wall_s"]) > 0.05 * t["wall_s"]:
                        raise AssertionError(f"request_trace phases {total} "
                                             f"against wall {t['wall_s']}: {t}")
                if turn == 1 and (st["steady_state_compiles"]
                                  or st["steady_state_reshards"]
                                  or st["decode_graph_captures"] != 1):
                    raise AssertionError(f"steady state compiled: {st}")
                row.update(
                    mfu_ledger=round(ledger / (run["wall"] * peak), 6),
                    mfu_script=round(ours / (run["wall"] * peak), 6),
                    ledger_vs_script=round(ledger / ours, 4),
                    device_busy_frac=[hb["device_busy_frac"] for hb in hbs],
                    dispatch_gap_ms=[hb["dispatch_gap_ms"] for hb in hbs],
                    hbm={k: last[k] for k in HBM_FIELDS},
                    hbm_components={k: v for k, v in last.items()
                                    if k.startswith("hbm_") and k not in HBM_FIELDS},
                    steady_state_compiles=st["steady_state_compiles"],
                    watchdog_alerts=st["watchdog_alerts"],
                    events=len(run["events"]))
            rows.append(row)
        for a in runs[1:]:
            for x, y, b in zip(a["outs"], runs[0]["outs"], budgets):
                if not np.array_equal(x, y):
                    raise AssertionError(f"tokens differ between {a['name']} "
                                         f"turn {a['turn']} and off turn 0")
        del servers, on
        torch.cuda.empty_cache()
        drills = telemetry_drills(params, cfg, prompts, budgets)
    finally:
        obs.set_default_sink(prev_sink)
        sink.close()
        if prev_flight is None:
            os.environ.pop("KATATPU_FLIGHT_DIR", None)
        else:
            os.environ["KATATPU_FLIGHT_DIR"] = prev_flight
    out_dir = os.path.join(HERE, "chiprun_out")
    if os.path.isdir(out_dir):
        shutil.copy(sink_path, os.path.join(out_dir, "telemetry_events.jsonl"))
    off_s = [r["tok_s"] for r in rows if r["server"] == "off"]
    on_s = [r["tok_s"] for r in rows if r["server"] == "on"]
    cost = 100.0 * (1.0 - sum(on_s) / sum(off_s))
    for k, n in drills.pop("launches").items():
        launches[k] = launches.get(k, 0) + n
    emit("telemetry", nvidia_smi=smi, config=PAGED_KW, requests=len(prompts),
         runs=rows, tok_s_off=off_s, tok_s_on=on_s,
         telemetry_cost_pct=round(cost, 3), peak_flops=peak, **drills,
         launches=launches)
    return launches


# ----- the guards ------------------------------------------------------------

GUARDS_DIR = os.path.join(HERE, "build", "guards")
# The serving forms the strict drains cover, each on the paged phase's
# config: the server's keyword arguments past it.
GUARD_FORMS = {
    "paged_int8_overlapped": {},
    "fused": dict(sched_policy="slo_chunked", itl_slo_ms=0.0, prefill_chunk=128,
                  fused=True),
    "persistent": dict(persistent=True),
    "slo_chunked": dict(sched_policy="slo_chunked", itl_slo_ms=0.0,
                        prefill_chunk=128, fused=False),
    "prefix_host_tier": dict(prefix_cache_tokens=1, kv_host_tokens=4096),
}
# The race harness's size in the phase: 20 seeded iterations, two kubelet
# restarts each (RACE_* of tests/torch_race_harness.py).
GUARD_RACE_ENV = dict(RACE_ITERS="20", RACE_RESTARTS="2", RACE_OPS="8")


def start_guard_checks() -> dict:
    """Start the analyzer and the race harness, each in a process of its
    own (they need no card), writing under :data:`GUARDS_DIR`."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=HERE, RACE_ARTIFACTS=os.path.join(GUARDS_DIR, "race"),
               **GUARD_RACE_ENV)
    procs = {}
    for name, cmd in (
            ("torchguard", [sys.executable, "-m", "tools.torchguard", "--json",
                            os.path.join(GUARDS_DIR, "torchguard.json")]),
            ("race", [sys.executable, os.path.join("tests", "torch_race_harness.py")])):
        out = open(os.path.join(GUARDS_DIR, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(cmd, cwd=HERE, env=env, stdout=out,
                                        stderr=subprocess.STDOUT), out,
                       time.perf_counter())
    return procs


def finish_guard_checks(procs: dict, timeout: float = 240.0) -> dict:  # torchguard: allow(TL004) times processes that never touch the card
    """Wait for the processes of :func:`start_guard_checks` (killing any
    that outlive ``timeout``) and read their results: the analyzer's
    report must hold no finding, the harness must end clean."""
    rows = {}
    for name, (proc, out, t0) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        out.close()
        with open(os.path.join(GUARDS_DIR, f"{name}.log")) as fh:
            log = fh.read()
        rows[name] = {"rc": rc, "s": round(time.perf_counter() - t0, 2)}
        if rc != 0:
            raise AssertionError(f"guards: {name} exited {rc}:\n{log[-3000:]}")
        if name == "torchguard":
            with open(os.path.join(GUARDS_DIR, "torchguard.json")) as fh:
                summary = json.load(fh)["summary"]
            if summary["total"]:
                raise AssertionError(f"torchguard found {summary}:\n{log[-3000:]}")
            rows[name].update(findings=summary["total"], by_rule=summary["by_rule"],
                              files=summary["files"], sanctions=summary["sanctions"],
                              sanctioned_by_rule=summary["sanctioned_by_rule"])
        else:
            result = json.loads(next(ln for ln in log.splitlines()
                                     if ln.startswith('{"iterations"')))
            if result["iterations"] != int(GUARD_RACE_ENV["RACE_ITERS"]):
                raise AssertionError(f"race harness: {result}")
            rows[name].update(result)
    return rows


def strict_drains(srv, prompts, budgets, sink_path: str) -> list:
    """Two drains of the same requests through a warmed strict server:
    for each, tok/s, the kernels' launches, the captures, compiles and
    reshards the drain added, and the ``guard_trip`` events on the
    stream."""
    import torch

    from kata_xpu_device_plugin_tpu_torch import obs

    kernels = counted_kernels()
    rows = []
    for drain in (1, 2):
        before = srv.stats()
        mark = os.path.getsize(sink_path)
        rids = [srv.submit(p, int(b)) for p, b in zip(prompts, budgets)]
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        results = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stats()
        for rid, b in zip(rids, budgets):
            out = results[rid]
            if len(out) != int(b) or not ((out >= 0) & (out < srv.cfg.vocab_size)).all():
                raise AssertionError(f"request {rid}: {len(out)} tokens, budget {b}")
        trips = [e for e in obs.read_events(sink_path, mark)
                 if e["name"] == "guard_trip"]
        rounds = st["rounds"] - before["rounds"]
        steps = (st["persistent_steps_executed"] - before["persistent_steps_executed"]
                 if srv._persistent else rounds * st["decode_steps"] * srv.chunk)
        rows.append(dict(
            drain=drain, wall_s=round(wall, 4),
            tok_s=round(float(sum(budgets)) / wall, 2), rounds=rounds,
            decode_steps_run=steps,
            launches={k: fn.launches for k, fn in kernels.items() if fn.launches},
            guard_trips=len(trips),
            captures=sum(st[k] - before[k] for k in (
                "decode_graph_captures", "persistent_graph_captures") if k in st),
            steady_state_compiles=st["steady_state_compiles"],
            steady_state_reshards=st["steady_state_reshards"]))
    return rows


def phase_guards(params, cfg, smi: str, seed: int = 0) -> dict:
    """The guards phase (module doc, 7a'). Returns its kernel launches."""
    import torch

    from kata_xpu_device_plugin_tpu_torch import obs
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    shutil.rmtree(GUARDS_DIR, ignore_errors=True)
    os.makedirs(GUARDS_DIR)
    procs = start_guard_checks()
    sink_path = os.path.join(GUARDS_DIR, "events.jsonl")
    sink = obs.EventSink(sink_path)
    prev_sink = obs.set_default_sink(sink)
    prompts, budgets, _lens = phase_requests(16, cfg.vocab_size, seed, skip=100)
    p_prompts, p_budgets, _pl, _order = prefix_requests(cfg.vocab_size, seed)
    launches, forms, problems = {}, {}, []
    try:
        for name, extra in GUARD_FORMS.items():
            srv = GenerationServer(params, cfg, strict=True, **PAGED_KW, **SERVE_KW,
                                   **extra)
            (warm_persistent if extra.get("persistent") else warm_server)(srv)
            reqs = ((p_prompts[:16], p_budgets[:16]) if "prefix_cache_tokens" in extra
                    else (prompts, budgets))
            rows = strict_drains(srv, *reqs, sink_path)
            st = srv.stats()
            guarded = srv.overlap and not srv._persistent
            del srv
            torch.cuda.empty_cache()
            for row in rows:
                for k, n in row["launches"].items():
                    launches[k] = launches.get(k, 0) + n
                # A prefix hit's suffix takes the plain attention (the JAX
                # rule): a drain of hits alone launches no flash kernel.
                want = ({"paged_decode"} if "prefix_cache_tokens" in extra
                        else {"flash_fwd", "paged_decode"})
                if (row["guard_trips"] or row["captures"]
                        or not want <= set(row["launches"])
                        <= {"flash_fwd", "paged_decode"}
                        or row["launches"]["paged_decode"]
                        != row["decode_steps_run"] * cfg.n_layers):
                    problems.append(f"{name} drain {row['drain']}: {row}")
            if st["steady_state_compiles"] or st["steady_state_reshards"]:
                problems.append(f"{name}: steady state {st['steady_state_compiles']} "
                                f"compiles, {st['steady_state_reshards']} reshards")
            forms[name] = dict(config=extra, drains=rows,
                               strict_scope="overlapped round" if guarded else
                               "none: lock-step rounds run outside strict, as in JAX")
            if name == "prefix_host_tier":
                forms[name].update(prefix_hits=st["prefix_hits"],
                                   kv_demotions=st["kv_demotions"])
    finally:
        obs.set_default_sink(prev_sink)
        sink.close()
        checks = finish_guard_checks(procs)
    emit("guards", nvidia_smi=smi, config=PAGED_KW, requests=len(prompts),
         torchguard=checks["torchguard"], race=checks["race"], forms=forms,
         launches=launches)
    if problems:
        raise AssertionError(f"guards: {problems}")
    return launches


# ----- persistent rounds and admission scheduling ----------------------------


def phase_requests(n: int, vocab: int, seed: int = 0, skip: int = 0):
    """The serving phases' requests: ``n`` prompts of 64-1000 tokens with
    budgets of 64-128, from ``seed`` (``skip`` draws thrown away first, as
    the serve phase does): the serve phase's with ``n=16, skip=100``, the
    paged phase's with ``n=32``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if skip:
        rng.integers(0, vocab, skip)
    lens = rng.integers(64, 1001, n)
    budgets = rng.integers(64, 129, n)
    prompts = [rng.integers(0, vocab, k).astype(np.int32) for k in lens]
    return prompts, budgets, lens


# The prefix phase: 4 lineages of one 512-token head each (a system prompt
# or template), a warm wave of one request a lineage, a main wave of six
# a lineage, lineage by lineage, and a return wave of one a lineage.
PREFIX_HEAD = 512
PREFIX_WAVES = (4, 24, 4)


def prefix_requests(vocab: int, seed: int = 0):
    """The prefix phase's requests: each a lineage's head plus a suffix of
    32-480 tokens of its own, budgets 64-128, all from ``seed``. Returns
    ``(prompts, budgets, lens, lineage of each)`` in submit order; the
    waves are :data:`PREFIX_WAVES` long."""
    import numpy as np

    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, PREFIX_HEAD).astype(np.int32)
             for _ in range(4)]
    order = [*range(4), *(ln for ln in range(4) for _ in range(6)), *range(4)]
    prompts = [np.concatenate([heads[ln], rng.integers(0, vocab, n).astype(np.int32)])
               for ln, n in zip(order, rng.integers(32, 481, len(order)))]
    budgets = rng.integers(64, 129, len(order))
    return prompts, budgets, np.array([len(p) for p in prompts]), order


# Counters of a persistent server that run_persistent reports for its
# timed run alone.
PERSISTENT_COUNTERS = ("rounds", "prefills", "tokens_emitted", "preemptions",
                       "persistent_rounds", "delivered_steps_total",
                       "delivered_lane_steps", "persistent_steps_executed",
                       "persistent_graph_replays")


def warm_persistent(srv) -> dict:
    """:func:`warm_server` for a persistent server: two short requests of
    unequal budgets, so that the first round runs eagerly and ends when
    the shorter one finishes and the second captures the round's graph.
    Returns the stats after them."""
    import numpy as np

    from kata_xpu_device_plugin_tpu_torch.obs.metrics import Rolling

    for b in (4, 12):
        srv.submit(np.arange(1, 101, dtype=np.int32), b)
    srv.run()
    srv._ttft, srv._tok_lat = Rolling(), Rolling()
    return srv.stats()


def run_persistent(srv, prompts, budgets):
    """:func:`run_requests` for a persistent server. Its warm-up is
    :func:`warm_persistent`, so every round of the timed run is replays.
    Asserted: every
    budget returned in vocabulary; the exits partition the rounds, every
    round persistent; the tokens the rounds delivered to live lanes are
    the tokens emitted past each request's first; the paged kernel's
    launches are the steps executed x layers, counted through replays,
    one replay a group of ``sub_steps``; fewer than ``sub_steps`` steps
    a round ran past its exit."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        decode_attention,
        paged_decode_attention,
        paged_decode_shard_stats,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward

    kernels = {"flash_fwd": flash_forward, "paged_decode": paged_decode_attention,
               "paged_decode_shard": paged_decode_shard_stats,
               "dense_decode": decode_attention}
    base = warm_persistent(srv)
    rids = [srv.submit(p, int(b)) for p, b in zip(prompts, budgets)]
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    life = srv.stats()
    st = {**life, **{k: life[k] - base[k] for k in PERSISTENT_COUNTERS}}
    st["persistent_exits"] = {k: v - base["persistent_exits"][k]
                              for k, v in life["persistent_exits"].items()}
    outs = [results[r] for r in rids]
    for rid, out, b in zip(rids, outs, budgets):
        if len(out) != int(b) or not ((out >= 0) & (out < srv.cfg.vocab_size)).all():
            raise AssertionError(f"request {rid}: {len(out)} tokens, budget {b}")
    sub = st["sub_steps"] = srv._round.sub_steps
    executed, rounds = st["persistent_steps_executed"], st["persistent_rounds"]
    st["steps_past_exit"] = executed - st["delivered_steps_total"]
    problems = []
    if set(launches) != {"flash_fwd", "paged_decode"}:
        problems.append(f"launches {launches}")
    if launches.get("paged_decode") != executed * srv.cfg.n_layers:
        problems.append(f"paged launches {launches} for {executed} steps")
    if base["persistent_graph_captures"] != 1 or life["persistent_graph_captures"] != 1:
        problems.append("not one capture, in the warm-up")
    if st["persistent_graph_replays"] * sub != executed:
        problems.append("a round of the timed run left the graph")
    if sum(st["persistent_exits"].values()) != rounds or rounds != st["rounds"]:
        problems.append(f"exits {st['persistent_exits']} over {rounds} rounds")
    if st["tokens_emitted"] - st["prefills"] != st["delivered_lane_steps"]:
        problems.append("delivered tokens are not the tokens emitted")
    if not 0 <= st["steps_past_exit"] <= rounds * (sub - 1):
        problems.append(f"{st['steps_past_exit']} steps past exits")
    if problems:
        raise AssertionError(f"persistent serving: {problems}: {st}")
    return outs, wall, launches, st


def checked_paged(kernel_fn, cases: list, block_size: int, paged_len: int):
    """``kernel_fn`` (a server's paged decode function) with every call
    held against the plain version on its own inputs, appended to
    ``cases``. Eager only: a check reads its result on the host."""
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import paged_decode_reference

    def checked(q, ck, cv, tables, pos, q_lens=None):
        out = kernel_fn(q, ck, cv, tables, pos, q_lens)
        if tables is None:  # the slotted arena through its pool view
            return out
        kw = dict(block_size=block_size, paged_len=paged_len)
        ref = paged_decode_reference(q, ck, cv, tables, pos, q_lens, **kw)
        mag = paged_decode_reference(q.float(), ck, v_abs(cv), tables, pos,
                                     q_lens, **kw)
        cases.append(check("persistent layer", out, ref, mag))
        return out

    return checked


def persistent_graph_check(params, cfg, kw, seed: int = 0) -> dict:
    """A persistent round by CUDA graph against the same round eager: a
    persistent server admits 8 requests and runs its first round eagerly,
    each layer's paged kernel call held against the plain version (paged
    only; the slotted view's tables are synthetic); then the second round
    runs eagerly (``_decode_while``) on a clone of the arena and through
    the server's graph (its capture, then replays) on the live arena,
    from the same inputs. Tokens, ``delivered``, ``tok``, ``pos`` and
    every arena byte must be equal, and the graph's kernel launches the
    steps it executed x layers."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models.transformer import _decode_while
    from kata_xpu_device_plugin_tpu_torch.ops import attention
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import paged_decode_attention
    from kata_xpu_device_plugin_tpu_torch.ops.quant import QTensor

    srv = GenerationServer(params, cfg, persistent=True, **kw)
    rng = np.random.default_rng(seed)
    # Round 1 ends when the first request finishes (19 steps), round 2
    # when the second does (40 more); the rest outlast both.
    for n, b in zip(rng.integers(64, 1001, 8), (20, 60) + (300,) * 6):
        srv.submit(rng.integers(0, cfg.vocab_size, n), b)
    rnd, cases = srv._round, []
    kernel_fn = rnd.decode_kernel_fn
    rnd.decode_kernel_fn = checked_paged(kernel_fn, cases, srv.kv_block,
                                         srv.max_len)
    srv.step()  # admission, then the first round, eager
    rnd.decode_kernel_fn = kernel_fn
    first, first_executed = srv.stats(), rnd.executed
    srv._ensure_blocks()
    arena = srv.kv_pool.arena if srv.paged else srv.arena
    leaves = [t for c in arena for t in (c if isinstance(c, QTensor) else (c,))]
    clone = [t.clone() for t in leaves]
    it = iter(clone)
    eager_arena = tuple(type(c)(*(next(it) for _ in c)) if isinstance(c, QTensor)
                        else next(it) for c in arena)

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to("cuda")

    tok, pos, budget = dev(srv._last), dev(srv._pos), dev(srv._decode_budget())
    window = dev(srv._persistent_window())
    tables = dev(srv._bt_host) if srv.paged else None
    t0 = time.perf_counter()
    want = _decode_while(params, eager_arena, tok, pos, budget, window, cfg,
                         rnd.cap, attn_fn=attention.reference_attention,
                         block_tables=tables, decode_kernel_fn=kernel_fn,
                         sub_steps=rnd.sub_steps, **rnd._kw)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    d0 = paged_decode_attention.launches
    t0 = time.perf_counter()
    out, g_tok, g_pos, delivered = rnd(tok, pos, budget, window, tables)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    launched = paged_decode_attention.launches - d0
    w_out, _, w_tok, w_pos, w_delivered = want
    d = int(w_delivered)
    outs_equal = (delivered == d and torch.equal(out[:, :d], w_out[:, :d])
                  and torch.equal(g_tok, w_tok) and torch.equal(g_pos, w_pos))
    arena_equal = all(torch.equal(_bits(a), _bits(c)) for a, c in zip(leaves, clone))
    row = dict(arena="paged" if srv.paged else "slotted",
               first_round_delivered=first["delivered_steps"],
               first_round_executed=first_executed,
               first_round_layer_checks=len(cases),
               first_round_max_err_over_bound=max(
                   (c["max_err_over_bound"] for c in cases), default=None),
               delivered=d, executed=rnd.executed, sub_steps=rnd.sub_steps,
               cap=rnd.cap, outputs_bit_equal=outs_equal,
               arena_bit_equal=arena_equal,
               arena_bytes_compared=sum(t.numel() * t.element_size() for t in leaves),
               graph_launches=launched, captures=rnd.captures,
               replays=rnd.replays, capture_s=round(rnd.capture_s, 4),
               graph_pool_bytes=rnd.pool_bytes, eager_round_s=round(eager_s, 6),
               graph_round_s=round(graph_s, 6))
    emit("persistent_graph_check", **row)
    want_checks = first_executed * cfg.n_layers if srv.paged else 0
    if (not (outs_equal and arena_equal) or d < 1
            or launched != rnd.executed * cfg.n_layers
            or (rnd.captures, rnd.replays) != (1, rnd.executed // rnd.sub_steps)
            or len(cases) != want_checks):
        raise AssertionError(f"persistent round by graph differs from eager: {row}")
    return row


def phase_persistent(params, cfg, seed: int = 0) -> dict:
    """Persistent rounds, slotted (the serve phase's 16 requests) and over
    the paged pool (the paged phase's 32), each beside the lock-step
    server on the same requests and config, whose tokens they must equal;
    then :func:`persistent_graph_check` for both arenas."""
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    launches = {}
    for arena, kw, n, skip in (
            ("slotted", dict(max_batch=8, **SERVE_KW), 16, 100),
            ("paged", dict(**PAGED_KW, **SERVE_KW), 32, 0)):
        prompts, budgets, lens = phase_requests(n, cfg.vocab_size, seed, skip)
        srv = GenerationServer(params, cfg, persistent=True, **kw)
        outs, wall, got, st = run_persistent(srv, prompts, budgets)
        del srv
        lock = GenerationServer(params, cfg, overlap=False, **kw)
        outs_l, wall_l, launches_l, st_l = run_requests(lock, prompts, budgets)
        del lock
        match = token_match(outs, outs_l, budgets)
        rounds = st["persistent_rounds"]
        row = serve_row(st, wall, budgets, lens, got)
        row.pop("decode_graph")
        emit("persistent", arena=arena, config=kw, **row,
             persistent_cap=st["persistent_cap"],
             sub_steps=st["sub_steps"],
             exits=st["persistent_exits"],
             mean_delivered_per_round=round(st["delivered_steps_total"] / rounds, 3),
             steps_executed=st["persistent_steps_executed"],
             steps_past_exit=st["steps_past_exit"],
             preemptions=st["preemptions"],
             persistent_graph_replays=st["persistent_graph_replays"],
             lockstep_same_requests={k: v for k, v in serve_row(
                 st_l, wall_l, budgets, lens, launches_l).items() if k in SIDE_KEYS}
             | {"preemptions": st_l["preemptions"]},
             token_match_vs_lockstep=match)
        if match["requests_identical"] != len(budgets):
            raise AssertionError(f"persistent tokens differ from lock-step: {match}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        persistent_graph_check(params, cfg, kw, seed)
    return launches


@contextlib.contextmanager
def checking_flash(cases: list):
    """Within the block, every flash forward the model's prefill makes
    (``ops.attention.flash_attention``) is held against the plain version
    on its own inputs, appended to ``cases``."""
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    orig, ref = attention.flash_attention, attention.reference_attention

    def checked(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        mag = ref(q.float(), k.float(), v.abs().float(), **kw)
        cases.append(check("sched prefill layer", out, ref(q, k, v, **kw), mag))
        return out

    attention.flash_attention = checked
    try:
        yield cases
    finally:
        attention.flash_attention = orig


def first_difference_margin(params, cfg, prompts, outs, other) -> dict:
    """Where two servers' tokens first part: the request, the token's
    index, and the top-2 margin of the plain path's logits there (the
    prompt and the shared tokens before it through a plain prefill);
    None when they never part."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import prefill
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    for i, (a, b) in enumerate(zip(outs, other)):
        diff = np.flatnonzero(a != b)
        if not len(diff):
            continue
        j = int(diff[0])
        ctx = np.concatenate([prompts[i], a[:j]]).astype(np.int64)
        toks = torch.from_numpy(ctx)[None].to("cuda")
        _c, logits, _p = prefill(params, toks, cfg, len(ctx),
                                 attn_fn=attention.reference_attention,
                                 return_logits=True, kv_quantized=True)
        top = torch.topk(logits[0], 2).values
        return {"request": i, "index": j, "tokens": [int(a[j]), int(b[j])],
                "plain_top2_margin": float(top[0] - top[1])}
    return None


def plain_step_logits(p, cfg, toks, fn, prefill_fn, quantized: bool,
                      record=None, force=None):
    """fp32 logits of the lock-step server's step that chose the last
    token of ``toks [1, n]``: the tokens but the last prefilled into a
    cache (int8 when ``quantized``, else bf16) with ``prefill_fn``, then
    the last decoded over it with ``fn``. An MoE model's routing calls
    come in order, the prefill's layers then the decode step's: ``record``
    (a list), when given, receives each call's tokens and chosen experts;
    ``force`` (``{call: {row: experts}}``) sends those rows to those
    experts, gated by their own probabilities."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        CUDA_PAD,
        forward,
        prefill,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import moe

    n = toks.shape[1]
    pad = -(-(n - 1) // CUDA_PAD) * CUDA_PAD
    head = torch.nn.functional.pad(toks[:, :-1], (0, pad - (n - 1)))
    real, calls, force = moe._route, [], force or {}

    def route(prm, tokens, c):
        gates, top_e, probs = real(prm, tokens, c)
        for row, experts in force.get(len(calls), {}).items():
            top_e[row] = experts
            g = probs[row, experts]
            gates[row] = g / g.sum() if c.top_k > 1 else g
        calls.append(None)
        if record is not None:
            record.append((tokens.detach().clone(), top_e.clone()))
        return gates, top_e, probs

    moe._route = route
    try:
        caches, _l, _p = prefill(p, head, cfg, pad + 1, attn_fn=prefill_fn,
                                 kv_quantized=quantized, true_len=n - 1)
        at = torch.full((1,), n - 1, dtype=torch.int32, device=toks.device)
        return forward(p, toks[:, -1:], cfg, attn_fn=fn,
                       positions=at[:, None], kv_caches=caches,
                       cache_offset=at)[0][0, -1].float()
    finally:
        moe._route = real


# The routing-flip witness: once two plain steps route alike, each token's
# MoE input on the split step lies within this share of its largest |input|
# on the unsplit one. Rounding alone keeps it near 2^-7 at the first layer
# and grows it layer by layer on random weights (0.007-0.10 over the 4
# layers of the Mixtral test config on the CPU; 0.014-0.096 over 4 layers
# at Mixtral's widths on an H100); a shard's arithmetic wrong moves it by
# the input's size (1.3-2.3 on the CPU, one shard's experts misordered).
ROUTING_INPUT_TOL = 0.25


def routing_flip_witness(params, split, cfg, toks, quantized: bool,
                         got: int, ref: int, bound: float) -> dict:
    """Whether a parting of the server over ``split`` (the same MoE
    weights cut across shards, ``tp_serving_params``) from the unsplit
    server is a routing tie resolved the other way. The plain step over
    ``split`` (the code under test) must pick the server's token, and so
    must an independent path: the plain step over the unsplit ``params``
    with the experts of the tokens whose routing the two steps resolve
    apart forced to the split step's, level by level (layer l's routing
    depends only on the layers below it), until every token of every
    layer routes alike. Its gap ``logits[ref] - logits[got]`` must lie
    within ``bound``, and every layer's MoE inputs of the two routed-alike
    steps must agree within :data:`ROUTING_INPUT_TOL` of each token's
    largest |input|: then the two differ by rounding alone. A fault in the
    shards' arithmetic moves those inputs, whatever the routing. Printed
    beside: the tokens forced at each level."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops import attention

    ref_attn = attention.reference_attention
    L, n = cfg.n_layers, toks.shape[1]
    rec_s = []
    split_logits = plain_step_logits(split, cfg, toks, ref_attn, ref_attn,
                                     quantized, rec_s)

    def level(rec, lvl):  # layer lvl's real tokens: the prefill's, the decoded one
        return (torch.cat([rec[lvl][0][:n - 1], rec[L + lvl][0]]),
                torch.cat([rec[lvl][1][:n - 1], rec[L + lvl][1]]))

    force, forced = {}, []
    for _ in range(L + 1):
        rec_u = []
        logits = plain_step_logits(params, cfg, toks, ref_attn, ref_attn,
                                   quantized, rec_u, force)
        moved = None
        for lvl in range(L):
            eu, es = level(rec_u, lvl)[1], level(rec_s, lvl)[1]
            rows = (eu.sort(-1).values != es.sort(-1).values).any(-1).nonzero()
            if len(rows):
                moved = lvl, [int(r) for r in rows[:, 0]]
                break
        if moved is None:
            break
        lvl, rows = moved
        forced.append({"level": lvl, "tokens": len(rows)})
        for r in rows:
            call, row = (lvl, r) if r < n - 1 else (L + lvl, 0)
            force.setdefault(call, {})[row] = rec_s[call][1][row]
    errs = []
    for lvl in range(L):
        xu, xs = level(rec_u, lvl)[0].float(), level(rec_s, lvl)[0].float()
        errs.append(round(float(((xs - xu).abs().amax(-1)
                                 / xu.abs().amax(-1).clamp_min(2.0 ** -30)).max()), 6))
    split_gap = float(split_logits[ref] - split_logits[got])
    forced_gap = float(logits[ref] - logits[got])
    return {"split_gap": round(split_gap, 5), "forced_gap": round(forced_gap, 5),
            "forced": forced, "routed_alike": moved is None,
            "input_err_x_token_max": errs,
            "ok": (moved is None and split_gap <= bound
                   and forced_gap <= bound and max(errs) <= ROUTING_INPUT_TOL)}


def token_partings(params, cfg, prompts, outs, other, quantized: bool,
                   split=None) -> dict:
    """Where each request of ``outs`` first parts from ``other`` (the
    reference server's tokens): the index, both tokens, and the plain
    path's gap between the two, ``logits[ref] - logits[got]``, beside the
    logit RMS there and the gap's noise. The plain path is the lock-step
    server's step that chose the token (:func:`plain_step_logits`, the
    plain attention). The noise is the largest distance of the same two
    tokens' gap through an equally valid bf16 path: :func:`plain_fp32_p`
    in place of the plain attention, or the servers' own prefill (the
    flash kernel) before the plain step. A parting is a bf16 argmax flip,
    not a wrong token, when the gap lies within LOGIT_BOUND["decode"] x
    the RMS or :data:`NOISE_FACTOR` x its noise. ``split`` (the same MoE
    weights cut across shards) allows one more kind: a parting past that
    bound whose :func:`routing_flip_witness` holds, where the shards'
    step agrees with the unsplit one up to a router tie and past it picks
    the server's token. ``all_flips`` says whether every parting is one."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops import attention

    ref_attn = attention.reference_attention
    rows = []
    for i, (a, b) in enumerate(zip(outs, other)):
        n = min(len(a), len(b))
        diff = np.flatnonzero(np.asarray(a[:n]) != np.asarray(b[:n]))
        if not len(diff):
            continue
        j = int(diff[0])
        got, ref = int(a[j]), int(b[j])
        ctx = np.concatenate([prompts[i], b[:j]]).astype(np.int64)
        toks = torch.from_numpy(ctx)[None].to("cuda")
        logits, *alts = (plain_step_logits(params, cfg, toks, fn, pre, quantized)
                         for fn, pre in ((ref_attn, ref_attn),
                                         (plain_fp32_p, plain_fp32_p),
                                         (ref_attn, None)))
        gap = float(logits[ref] - logits[got])
        alt_gaps = [float(x[ref] - x[got]) for x in alts]
        noise = max(abs(gap - g) for g in alt_gaps)
        rms = float(logits.square().mean().sqrt())
        top = torch.topk(logits, 2).values
        bound = max(LOGIT_BOUND["decode"] * rms, NOISE_FACTOR * noise)
        row = {"request": i, "index": j, "tokens": [got, ref],
               "gap": round(gap, 5), "gap_x_rms": round(gap / rms, 5),
               "alt_gaps": [round(g, 5) for g in alt_gaps],
               "gap_noise": round(noise, 5), "logit_rms": round(rms, 5),
               "plain_top2_margin": round(float(top[0] - top[1]), 5),
               "flip": gap <= bound}
        if split is not None and not row["flip"]:
            row["routing_witness"] = routing_flip_witness(
                params, split, cfg, toks, quantized, got, ref, bound)
            row["flip"] = row["routing_witness"]["ok"]
        rows.append(row)
    return {"parted": len(rows), "all_flips": all(r["flip"] for r in rows),
            "partings": rows}


def chunked_first_logits(params, cfg, firsts, quantized: bool) -> dict:
    """Each chunked admission's first-token logits (``firsts``: prompt and
    logits, and for a prefix hit the match length ``m``) against three
    whole prefills of its prompt on the plain path, with the server's KV
    cache (int8 when ``quantized``, else bf16): ``plain``, the plain
    prefill, which attends over the fresh bf16 k/v; ``readback``, the
    prompt as one ``prefill_suffix`` slice from empty caches, which attends
    over the cache read back, as every chunk does (here and in the JAX
    package), or for a hit the two slices a hit runs: the head's plain
    prefill written to the cache, then the rest as one ``prefill_suffix``
    slice at ``m``; ``fp32_p``, the plain prefill with fp32
    probabilities, whose distance from ``plain`` is the noise floor
    rounding alone makes at this depth. Errors are max |difference| over
    the ``plain`` logits' RMS. Held within the serving bound: the chunks
    against the one-slice read-back, and, with a bf16 cache (whose
    read-back rows are the fresh k/v), against the plain prefill. An int8
    cache's read-back rounds every k/v row, and that alone moves the
    logits past the serving bound on these random weights
    (``readback_vs_plain``, printed)."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        init_kv_caches,
        prefill_batch,
        prefill_suffix,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    bound = LOGIT_BOUND["prefill"]
    rows = []
    for prompt, got, *head in firsts:
        m = head[0] if head else 0
        n = len(prompt)
        pad = next(b for b in SERVE_KW["prefill_buckets"] if b >= n)
        toks = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
        toks[0, :n] = torch.from_numpy(prompt)
        tl = torch.tensor([n], dtype=torch.int32)
        whole = {}
        for name, fn in (("plain", attention.reference_attention),
                         ("fp32_p", plain_fp32_p)):
            whole[name] = prefill_batch(params, toks, cfg, SERVE_KW["max_len"],
                                        tl, attn_fn=fn, kv_quantized=quantized)[1]
        if m:
            caches = prefill_batch(params, toks[:, :m], cfg, SERVE_KW["max_len"],
                                   torch.tensor([m], dtype=torch.int32),
                                   attn_fn=attention.reference_attention,
                                   kv_quantized=quantized)[0]
        else:
            caches = init_kv_caches(cfg, 1, SERVE_KW["max_len"], device="cuda",
                                    quantized=quantized)
        whole["readback"] = prefill_suffix(params, toks[:, m:].long(), cfg,
                                           caches, m, return_logits=True,
                                           true_len=n - m)[1]
        rms = float(whole["plain"].square().mean().sqrt())

        def err(a, b):
            return float((a - b).abs().max()) / rms

        row = {"prompt_len": n, "head": m, "vs_plain": err(got, whole["plain"]),
               "vs_readback": err(got, whole["readback"]),
               "readback_vs_plain": err(whole["readback"], whole["plain"]),
               "noise_floor": err(whole["fp32_p"], whole["plain"])}
        row["ok"] = (math.isfinite(row["vs_plain"]) and row["vs_readback"] <= bound
                     and (quantized or row["vs_plain"] <= bound))
        rows.append(row)
    keys = ("vs_plain", "vs_readback", "readback_vs_plain", "noise_floor")
    return {"kv": "int8" if quantized else "bf16", "compared": len(rows),
            "bound_x_rms": bound,
            **{f"max_{k}": max((r[k] for r in rows), default=None) for k in keys},
            "min_noise_floor": min((r["noise_floor"] for r in rows), default=None),
            "ok": bool(rows) and all(r["ok"] for r in rows), "per_admission": rows}


def phase_sched(params, cfg, seed: int = 0) -> dict:
    """Admission scheduling on the serve phase's config and 16 requests:
    the ``fifo_batch`` server, then ``slo_chunked`` with ``itl_slo_ms=0``
    (maximal chunking) and ``prefill_chunk=128``, fused and not, at the
    default deadline, and fused over a bf16 cache. Each run is timed
    (tok/s, TTFT, ITL) and its tokens matched against the fifo server's,
    with the plain top-2 margin where they first part. Asserted: chunks ran, fused ones rode decode
    dispatches; every chunked admission's first-token logits held
    against whole plain prefills of its prompt
    (:func:`chunked_first_logits`); every flash call of a whole admission
    pass within ``kernel_tolerance`` of the plain version."""
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    kw = dict(max_batch=8, **SERVE_KW)
    prompts, budgets, lens = phase_requests(16, cfg.vocab_size, seed, skip=100)
    fifo = GenerationServer(params, cfg, **kw)
    outs_f, wall_f, launches_f, st_f = run_requests(fifo, prompts, budgets)
    del fifo
    chunked = dict(sched_policy="slo_chunked", itl_slo_ms=0.0, prefill_chunk=128)
    runs = {"fused": dict(chunked, fused=True),
            "unfused": dict(chunked, fused=False),
            "default_slo": dict(sched_policy="slo_chunked"),
            "fused_bf16_kv": dict(chunked, fused=True, kv_quant=False)}
    launches, rows, firsts = dict(launches_f), {}, {True: [], False: []}
    for name, extra in runs.items():
        srv = GenerationServer(params, cfg, **kw, **extra)
        logits_seen, landed = [], []
        sample_first, commit = srv._sample_first, srv._commit_partial

        def recording_sample(logits, sample_first=sample_first, seen=logits_seen):
            seen.append(logits.float().clone())
            return sample_first(logits)

        def recording_commit(p, first, t, commit=commit, seen=logits_seen,
                             landed=landed):
            landed.append((p.req.prompt, seen[-1]))
            return commit(p, first, t)

        srv._sample_first, srv._commit_partial = recording_sample, recording_commit
        outs, wall, got, st = run_requests(srv, prompts, budgets)
        del srv
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if name != "default_slo":
            firsts[st["kv_quant"] == "int8"] += landed
        row = {k: v for k, v in serve_row(st, wall, budgets, lens, got).items()
               if k in SIDE_KEYS}
        row.update({k: st[k] for k in ("kv_quant", "sched_policy", "sched_chunks",
                                       "sched_defers", "fused_admissions",
                                       "slo_violations", "itl_slo_ms",
                                       "prefill_chunk_tokens")})
        row["chunked_admissions"] = len(landed)
        row["token_match_vs_fifo"] = token_match(outs, outs_f, budgets)
        row["first_difference"] = first_difference_margin(params, cfg, prompts,
                                                          outs, outs_f)
        rows[name] = row
    firsts_rows = [chunked_first_logits(params, cfg, firsts[q], q)
                   for q in (True, False)]
    cases = []
    srv = GenerationServer(params, cfg, **kw, **runs["fused"])
    for p, b in zip(prompts[:8], budgets[:8]):
        srv.submit(p, int(b))
    with checking_flash(cases):
        srv.step()  # the first admission pass: whole prefills, every layer checked
    del srv
    emit("sched", config=kw, requests=len(budgets),
         fifo_batch={k: v for k, v in serve_row(
             st_f, wall_f, budgets, lens, launches_f).items() if k in SIDE_KEYS},
         **rows, chunked_first_logits=firsts_rows,
         whole_admission_flash_checks=len(cases),
         whole_admission_flash_max_err_over_bound=max(
             (c["max_err_over_bound"] for c in cases), default=None))
    problems = []
    for name in ("fused", "unfused", "fused_bf16_kv"):
        if rows[name]["sched_chunks"] < 1 or rows[name]["chunked_admissions"] < 1:
            problems.append(f"{name}: no chunked admission")
    if (rows["fused"]["fused_admissions"] < 1 or rows["unfused"]["fused_admissions"]
            or rows["fused_bf16_kv"]["fused_admissions"] < 1):
        problems.append("fused admissions")
    for row in firsts_rows:
        if not row["ok"]:
            problems.append(f"chunked first-token logits {row}")
    if len(cases) < cfg.n_layers:
        problems.append(f"{len(cases)} flash checks")
    if problems:
        raise AssertionError(f"sched: {problems}")
    return launches


# ----- the shared-prefix cache and the host KV tier ---------------------------


def recording_admissions(srv, hits_seen: list, ttft: list) -> None:
    """Record, on ``srv``, each prefix-hit admission group's first-token
    logits (``hits_seen``: prompts, match length, logits ``[N, vocab]``) and
    each admission's TTFT with whether it hit (``ttft``)."""
    from kata_xpu_device_plugin_tpu_torch.guest import serving

    fill, finish = srv._fill_slots, srv._finish_admission

    def fill_recording(slots, reqs, pad_len, hits=None):
        if not hits:
            return fill(slots, reqs, pad_len)
        sample = serving._next_token

        def recording(logits, *a, **kw):
            hits_seen.append(([req.prompt for req in reqs], hits[0].length,
                              logits.float().clone()))
            return sample(logits, *a, **kw)

        serving._next_token = recording
        try:
            return fill(slots, reqs, pad_len, hits)
        finally:
            serving._next_token = sample

    def finish_recording(b, req, first, pos, t_first, hit=None, **event):
        ttft.append((t_first - req.t_submit, hit is not None))
        return finish(b, req, first, pos, t_first, hit=hit, **event)

    srv._fill_slots = fill_recording
    srv._finish_admission = finish_recording


def timing_resumes(srv, ms: list) -> None:
    """Record on ``srv`` the host milliseconds of each resume that landed."""
    resume = srv._resume_one

    def timed(b):  # torchguard: allow(TL004) host milliseconds of a resume by design: a fence would serialize the server it instruments
        t0 = time.perf_counter()
        landed = resume(b)
        if landed:
            ms.append(round((time.perf_counter() - t0) * 1e3, 4))
        return landed

    srv._resume_one = timed


def timing_stages(srv, marks: list) -> None:
    """Record on ``srv``, for each staged resume upload, CUDA events on the
    side stream before and after its copies and one on the main stream
    right behind the chunk just dispatched (``marks``): the upload's
    device time, and by how much the chunk outlasted it."""
    import torch

    stage = srv._stage_resume_prefetch
    srv._h2d_stream = torch.cuda.Stream()

    def timed():
        before = srv._stage
        start = torch.cuda.Event(enable_timing=True)
        start.record(srv._h2d_stream)
        stage()
        if srv._stage is not None and srv._stage is not before:
            up, chunk = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            up.record(srv._h2d_stream)
            chunk.record()
            marks.append((start, up, chunk))

    srv._stage_resume_prefetch = timed


def p50(xs):
    import numpy as np

    return float(np.percentile(xs, 50)) if len(xs) else None


def pool_rows_bits(pool, blocks, block_size: int) -> list:
    """The rows of ``blocks`` in every leaf of ``pool`` (int8 payloads and
    scales alike), as integers, so that equality is bit equality."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest.kv_arena import pool_gather_rows
    from kata_xpu_device_plugin_tpu_torch.guest.prefix_cache import cache_leaves

    table = torch.tensor(blocks, dtype=torch.int32, device="cuda")
    return [_bits(t).clone() for t in cache_leaves(
        pool_gather_rows(pool.arena, table, block_size))]


def demote_promote_exact(srv) -> dict:
    """Force the tier's least recently used unpinned segment down to the
    host tier and back: its rows (int8 payload and scales) before and after
    must be bit-equal, and the pool's tensors the ones the decode graph
    holds."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest.prefix_cache import cache_leaves

    tier, pool = srv.prefix_store, srv.kv_pool
    seg = min((s for s in tier._segments if not s.host and s.refs == 0),
              key=lambda s: s.tick)
    ptrs = [t.data_ptr() for t in cache_leaves(pool.arena)]
    before, blocks = pool_rows_bits(pool, seg.blocks, pool.block_size), list(seg.blocks)
    if not (tier._demote(seg) and seg.host and tier._promote(seg)):
        raise AssertionError("prefix: the forced demotion or promotion failed")
    after = pool_rows_bits(pool, seg.blocks, pool.block_size)
    torch.cuda.synchronize()
    return {"tokens": seg.length, "blocks_before": blocks[:4],
            "blocks_after": seg.blocks[:4],
            "bytes_compared": sum(t.numel() * t.element_size() for t in before),
            "bit_equal": all(torch.equal(a, b) for a, b in zip(after, before)),
            "pool_in_place": [t.data_ptr() for t in cache_leaves(pool.arena)] == ptrs}


def prefix_cow_check(params, cfg, prompts, budgets) -> dict:
    """Copy-on-write on the card: a lock-step server over a pool of 48-token
    blocks (a 512-token match ends mid-block), the warm wave served, then
    two hits a lineage admitted at once. Each hit's private boundary block
    must hold the tier block's prefix rows bit for bit; lanes must share
    tier blocks; one decode chunk run eagerly on a clone of the pool holds
    every paged kernel call against the plain version
    (:func:`checked_paged`); the rest of the run returns every budget and
    leaves the pool holding the tier's blocks alone."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import serve_decode
    from kata_xpu_device_plugin_tpu_torch.guest.prefix_cache import cache_leaves
    from kata_xpu_device_plugin_tpu_torch.ops.quant import QTensor

    bs = 48
    srv = GenerationServer(params, cfg, max_batch=16, kv_pool_tokens=8000,
                           kv_block_size=bs, prefix_cache_tokens=1,
                           overlap=False, **SERVE_KW)
    for p, b in zip(prompts[:4], budgets[:4]):
        srv.submit(p, int(b))
    srv.run()
    picks = [4 + 6 * ln + i for ln in range(4) for i in (0, 1)]
    rids = [srv.submit(prompts[i], int(budgets[i])) for i in picks]
    srv.step()
    pool, exe = srv.kv_pool, srv._decode
    boundary, lanes = [], 0
    for b, hit in enumerate(srv._slot_prefix):
        if hit is None:
            continue
        lanes += 1
        k, r = hit.length // bs, hit.length % bs
        mine, theirs = srv._lane_blocks[b][k], hit.segment.blocks[k]
        boundary.append(all(
            torch.equal(_bits(t[:, 0, mine * bs: mine * bs + r]),
                        _bits(t[:, 0, theirs * bs: theirs * bs + r]))
            for t in cache_leaves(pool.arena)))
    held = [blk for t in srv._lane_blocks for blk in t]
    shared = sum(1 for blk in set(held) if held.count(blk) > 1)
    srv._ensure_blocks()
    clone = iter([t.clone() for t in cache_leaves(pool.arena)])
    eager_arena = tuple(type(c)(*(next(clone) for _ in c)) if isinstance(c, QTensor)
                        else next(clone) for c in pool.arena)

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to("cuda")

    cases = []
    serve_decode(params, eager_arena, dev(srv._last), dev(srv._pos), cfg,
                 exe.steps, checked_paged(exe.decode_kernel_fn, cases, bs,
                                          SERVE_KW["max_len"]),
                 block_tables=dev(srv._bt_host), **exe._kw)
    torch.cuda.synchronize()
    out = srv.run()
    st = srv.stats()
    row = {"block_size": bs, "hit_lanes": lanes, "cow_copies": st["cow_copies"],
           "boundary_rows_bit_equal": boundary, "blocks_shared_by_lanes": shared,
           "eager_chunk_kernel_calls_checked": len(cases),
           "eager_chunk_max_err_over_bound": max(
               (c["max_err_over_bound"] for c in cases), default=None),
           "kv_blocks_in_use": st["kv_blocks_in_use"],
           "tier_blocks": srv.prefix_store.blocks_used}
    problems = []
    if not (st["cow_copies"] > 0 and lanes == len(picks) and all(boundary)):
        problems.append("copy on write")
    if not shared:
        problems.append("no block shared by two lanes")
    if len(cases) != exe.steps * cfg.n_layers:
        problems.append(f"{len(cases)} checked kernel calls")
    if [len(out[r]) for r in rids] != [int(budgets[i]) for i in picks]:
        problems.append("budgets")
    if st["kv_blocks_in_use"] != srv.prefix_store.blocks_used:
        problems.append("blocks leaked")
    if problems:
        raise AssertionError(f"prefix cow: {problems} {row}")
    return row


def phase_prefix(params, cfg, seed: int = 0) -> dict:
    """The shared-prefix cache and the host KV tier at full Gemma-2B width:
    :func:`prefix_requests` (4 lineages of a 512-token head; waves of 4, 24
    and 4) through the default paged server of the paged phase, (a)
    without the cache, (b) with ``prefix_cache_tokens``, (c) with it and
    ``kv_host_tokens=4096``: tok/s, TTFT (hits and cold apart), ITL, hits,
    reuse, the tier's evictions, demotions, promotions, preemptions,
    copies on write, batched hit admissions, the token match of (b)
    against (a). Then (b)'s hits' first-token logits against the plain
    two-slice reference (int8 cache), a bf16-cache server's against the
    whole plain prefill; a forced demotion and promotion on (c), bit for
    bit; the paged phase's requests with ``kv_host_tokens=2048`` beside
    the tier-less server (tokens bit-equal, resumes from staged uploads,
    each resume's host ms); and :func:`prefix_cow_check`. Every run's
    kernel launches are counted through replays (:func:`run_requests`),
    and the pool ends holding the tier's blocks and nothing else."""
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer

    prompts, budgets, lens, _order = prefix_requests(cfg.vocab_size, seed)
    base_kw = dict(**PAGED_KW, **SERVE_KW)
    runs = {"a_no_cache": {}, "b_prefix": dict(prefix_cache_tokens=1),
            "c_prefix_host": dict(prefix_cache_tokens=1, kv_host_tokens=4096)}
    launches, rows, outs, hit_logits, problems = {}, {}, {}, {}, []

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for name, extra in runs.items():
        srv = GenerationServer(params, cfg, **base_kw, **extra)
        hits, ttft = [], []
        recording_admissions(srv, hits, ttft)
        outs[name], wall, got, st = run_requests(srv, prompts, budgets,
                                                 waves=PREFIX_WAVES)
        add(got)
        tier = srv.prefix_store
        looked = st["prefix_hits"] + st["prefix_misses"]
        row = {k: v for k, v in serve_row(st, wall, budgets, lens, got).items()
               if k in SIDE_KEYS}
        row.update({k: st[k] for k in (
            "prefix_hits", "prefix_tokens_reused", "kv_demotions",
            "kv_prefetches", "preemptions", "cow_copies", "kv_blocks_in_use")})
        row["prefix_hit_ratio"] = round(st["prefix_hits"] / looked, 4) if looked else 0.0
        row["tier_evictions"] = tier.stats()["evictions"] if tier else 0
        row["tier_blocks"] = tier.blocks_used if tier else 0
        row["hit_admission_groups"] = len(hits)
        row["hit_admissions_batched"] = sum(len(h[0]) for h in hits if len(h[0]) > 1)
        row["ttft_p50_hit_s"] = p50([t for t, hit in ttft if hit])
        row["ttft_p50_cold_s"] = p50([t for t, hit in ttft if not hit])
        if st["kv_blocks_in_use"] != row["tier_blocks"]:
            problems.append(f"{name}: {st['kv_blocks_in_use']} blocks in use, "
                            f"the tier holds {row['tier_blocks']}")
        if name == "c_prefix_host":
            row["demote_promote"] = demote_promote_exact(srv)
        hit_logits[name] = hits
        rows[name] = row
        del srv
    rows["b_prefix"]["token_match_vs_a"] = token_match(
        outs["b_prefix"], outs["a_no_cache"], budgets)
    rows["b_prefix"]["first_difference_margin"] = first_difference_margin(
        params, cfg, prompts, outs["b_prefix"], outs["a_no_cache"])
    firsts = [(p, logits[i:i + 1], m) for ps, m, logits in hit_logits["b_prefix"]
              for i, p in enumerate(ps)][:8]
    # A bf16-cache server: the warm wave, then the first hit of each lineage.
    picks = [*range(4), *(4 + 6 * ln for ln in range(4))]
    srv = GenerationServer(params, cfg, kv_quant=False, prefix_cache_tokens=1,
                           **base_kw)
    hits_bf16 = []
    recording_admissions(srv, hits_bf16, [])
    _o, _w, got, st16 = run_requests(srv, [prompts[i] for i in picks],
                                     [budgets[i] for i in picks], waves=(4, 4))
    add(got)
    del srv
    firsts_rows = [chunked_first_logits(params, cfg, firsts, True),
                   chunked_first_logits(
                       params, cfg, [(p, logits[i:i + 1], m)
                                     for ps, m, logits in hits_bf16
                                     for i, p in enumerate(ps)], False)]
    # The resume prefetch: the paged phase's preempting requests, no cache.
    pp, pb, _plens = phase_requests(32, cfg.vocab_size, seed)
    resume = {}
    for name, extra in (("no_tier", {}), ("host_2048", dict(kv_host_tokens=2048))):
        srv = GenerationServer(params, cfg, **base_kw, **extra)
        ms, marks = [], []
        timing_resumes(srv, ms)
        if extra:
            timing_stages(srv, marks)
        o, wall, got, st = run_requests(srv, pp, pb)
        add(got)
        resume[name] = {"outs": o, "tok_s": round(int(sum(pb)) / wall, 2),
                        **{k: st[k] for k in ("preemptions", "kv_prefetches",
                                              "kv_resume_staged", "kv_blocks_in_use")},
                        "resume_host_ms": ms, "resume_host_ms_p50": p50(ms)}
        if marks:
            resume[name]["staged_upload_ms"] = [
                round(a.elapsed_time(b), 4) for a, b, _ in marks]
            resume[name]["chunk_past_upload_ms"] = [
                round(b.elapsed_time(c), 4) for _, b, c in marks]
        del srv
    resume_equal = all((a == b).all() for a, b in zip(resume["no_tier"].pop("outs"),
                                                      resume["host_2048"].pop("outs")))
    cow = prefix_cow_check(params, cfg, prompts, budgets)
    emit("prefix", config=PAGED_KW, head=PREFIX_HEAD, waves=PREFIX_WAVES,
         requests=len(budgets), **rows, hit_first_logits=firsts_rows,
         bf16_kv_hits=st16["prefix_hits"], resume_prefetch=dict(
             resume, tokens_bit_equal=resume_equal), cow=cow)
    a, b, c = rows["a_no_cache"], rows["b_prefix"], rows["c_prefix_host"]
    if not (b["prefix_hits"] > 0 and c["prefix_hits"] > 0 and a["prefix_hits"] == 0):
        problems.append("prefix hits")
    if not (c["kv_demotions"] > 0 and c["kv_prefetches"] > 0):
        problems.append("no demotion or promotion in (c)")
    dp = c["demote_promote"]
    if not (dp["bit_equal"] and dp["pool_in_place"]):
        problems.append(f"demote/promote {dp}")
    for row in firsts_rows:
        if not row["ok"] or not row["compared"]:
            problems.append(f"hit first-token logits {row}")
    h = resume["host_2048"]
    if not (resume_equal and h["preemptions"] > 0 and h["kv_prefetches"] > 0
            and h["kv_resume_staged"] > 0):
        problems.append(f"resume prefetch {resume}")
    if problems:
        raise AssertionError(f"prefix: {problems}")
    return launches


# The families served at their published widths (random bf16 weights from
# seed 0, fused) by the default server over a paged pool: model -> the cut
# of its depth (with the window and rope cycles cut with it), max_len, and
# how many of its 16 prompts are long (4200-6000 tokens; the rest 64-1000).
LONG_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 6144, 8192)
# Gemma-2-2B's depth in the families and spec phases: 4 of its 26 layers
# (two window pairs; 8 before the guards phase joined). Its plain decode
# over 8192-key views is most of both phases' time, and the script's phases
# share one time limit.
FAMILY_GEMMA2_LAYERS = 4
FAMILIES = {
    "gemma2_2b": dict(layers=FAMILY_GEMMA2_LAYERS, max_len=8192, long=4),
    "qwen2_7b": dict(layers=None, max_len=2048, long=0),
    "gemma3_4b": dict(layers=6, max_len=2048, long=0),
    "mistral_7b": dict(layers=4, max_len=8192, long=4),
}
SAMPLE_KW = dict(temperature=0.7, top_k=50, top_p=0.9, seed=0)


def family_config(name: str, layers):
    """The family's published config, its depth cut to ``layers`` with its
    per-layer cycles cut to their first ``layers`` entries."""
    from kata_xpu_device_plugin_tpu_torch import models

    cfg = getattr(models, name)()
    if layers is None:
        return cfg, f"none: all {cfg.n_layers} layers"
    cut = {"n_layers": layers}
    for f in ("attn_windows", "rope_theta_cycle", "rope_linear_cycle"):
        if getattr(cfg, f):
            cut[f] = getattr(cfg, f)[:layers]
    return (replace(cfg, **cut),
            f"n_layers={layers} (from {cfg.n_layers}; the phase's share of the "
            "run's time), window and rope cycles cut to their first entries")


def phase_families(seed: int = 0, profile: bool = False) -> dict:
    """Each family of :data:`FAMILIES` through the default server (overlapped,
    K = 1, graphed, int8 KV, paged: 16 lanes, tile 16): 16 greedy requests
    (tok/s, TTFT, ITL, the decode backend and its reason, captures and
    replays, launches); the same requests sampled (``SAMPLE_KW``) by two
    servers of one seed, whose tokens must be equal; ``graph_check`` on a
    sampled chunk; the served prefill (and, where the decode kernel runs,
    the first decode step) of a request held against the plain path.
    Qwen2-7B decodes through the paged kernel at its group of 7; the
    windowed families decode with the plain attention by the JAX rule.
    Every family runs before any failure is raised. ``profile`` adds a
    profiled window of decode rounds of each (16 lanes busy)."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models import (
        fuse_decoder_params,
        init_params,
    )

    launches, failures = {}, []
    for name, spec in FAMILIES.items():
        cfg, reduced = family_config(name, spec["layers"])
        t0 = time.perf_counter()
        params = fuse_decoder_params(
            init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        max_len = spec["max_len"]
        buckets = tuple(b for b in LONG_BUCKETS if b <= min(max_len, 8192)
                        and (spec["long"] or b <= 1024))
        kw = dict(max_batch=16, max_len=max_len, prefill_buckets=buckets,
                  chunk=8, kv_pool_tokens=16 * max_len + 32, kv_block_size=16)
        rng = np.random.default_rng(seed)
        lens = rng.integers(64, 1001, 16)
        lens[: spec["long"]] = rng.integers(4200, 6001, spec["long"])
        budgets = rng.integers(64, 129, 16)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        windowed = any(w > 0 for w in cfg.window_cycle)
        want = ("reference", "sliding_window") if windowed else ("cuda_paged", "")
        srv = GenerationServer(params, cfg, **kw)
        outs, wall, fam_launches, stats = run_requests(srv, prompts, budgets)
        del srv
        got = (stats["decode_backend"], stats["decode_backend_reason"])
        if got != want or stats["kv_quant"] != "int8":
            failures.append(f"{name}: decode backend {got}, want {want}")
        row = serve_row(stats, wall, budgets, lens, fam_launches)
        launches[name] = fam_launches
        sampled = []
        for _ in range(2):
            side = GenerationServer(params, cfg, **kw, **SAMPLE_KW)
            outs_s, wall_s, _, stats_s = run_requests(side, prompts, budgets)
            sampled.append((outs_s, wall_s, stats_s))
            del side
        repeat = token_match(sampled[0][0], sampled[1][0], budgets)
        if repeat["requests_identical"] != len(budgets):
            failures.append(f"{name}: sampled runs of one seed differ {repeat}")
        gc_row = graph_check(params, cfg, dict(kw, **SAMPLE_KW), seed=seed)
        long_i = 0 if spec["long"] else int(np.argmax(lens))
        cc = crosscheck(params, cfg, prompts[long_i], buckets, max_len,
                        decode=not windowed)
        try:
            assert_family_crosscheck(cc, cfg.n_layers)
        except AssertionError as e:
            failures.append(f"{name}: {e}")
        emit("family", model=name, reduced=reduced, max_len=max_len,
             config=dict(kw), init_s=round(init_s, 3),
             prompt_lens=lens.tolist(), **row,
             decode_backend=got[0], decode_backend_reason=got[1],
             sampled=dict(SAMPLE_KW, tok_s=round(int(sum(budgets))
                                                  / sampled[0][1], 2),
                          itl_p50_s=sampled[0][2]["decode_token_s"]["p50"],
                          repeat=repeat,
                          token_match_vs_greedy=token_match(
                              sampled[0][0], outs, budgets)),
             graph_check_sampled=gc_row["outputs_bit_equal"]
             and gc_row["arena_bit_equal"],
             crosscheck={k: v for k, v in cc.items() if k != "logit_bound_x_rms"})
        if profile:
            profile_rounds(params, cfg, kw, rng, lanes=16, model=name)
        del params
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("families: " + "; ".join(failures))
    return launches


# ----- tensor-parallel serving ------------------------------------------------

# The tp phase's servers beside tp=1: (name, degree, KV layout).
TP_RUNS = (("tp2_heads", 2, "heads"), ("tp2_blocks", 2, "blocks"),
           ("tp4_blocks", 4, "blocks"))


def shard_inputs(B, H, KV, D, bs, tp, quantized, keys=2048, seed=0):
    """A shard-local decode call's inputs on the card: a block-sharded pool
    of ``tp`` sub-pools of ``nbl`` blocks (shard ``s`` holds global blocks
    ``[s·nbl, (s+1)·nbl)``; block 0 the ZERO block) and ``B`` lanes at
    ragged positions: lane 0's blocks all on shard 0, lane 1's all on the
    last shard, the others' drawn from the shards in turn (as the pool's
    allocator deals them), the last lane dead over blocks of every shard.
    Table entries past a lane's position are unmapped (ZERO). Returns
    ``(q, k, v, tables, pos, nbl, kw)``."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops.quant import quantize_kv

    rng = np.random.default_rng(seed + bs + tp + KV + int(quantized))
    nb = keys // bs
    nbl = B * nb // tp + nb + 2
    nt = tp * nbl * bs
    g = torch.Generator(device="cuda").manual_seed(seed + bs + tp)
    q = torch.randn(B, 1, H, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pk = torch.randn(1, nt, KV, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pv = torch.randn(1, nt, KV, D, generator=g, device="cuda", dtype=torch.bfloat16)
    pk[0, :bs] = 0.0
    pv[0, :bs] = 0.0
    nxt = [2] * tp  # each shard's next free local block

    def take(shard):
        nxt[shard] += 1
        return shard * nbl + nxt[shard] - 1

    pos = rng.integers(0, keys, B)
    pos[:2] = rng.integers(keys // 2, keys, 2)
    pos[-1] = 10_000
    tables = np.zeros((B, nb), np.int32)
    for b in range(B - 1):
        for j in range(nb):
            shard = 0 if b == 0 else tp - 1 if b == 1 else (b + j) % tp
            tables[b, j] = take(shard) if j <= pos[b] // bs else 0
    tables[-1] = rng.integers(2, tp * nbl, nb)
    k, v = (quantize_kv(pk), quantize_kv(pv)) if quantized else (pk, pv)
    return (q, k, v, torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos.astype(np.int32)).cuda(), nbl,
            dict(block_size=bs, paged_len=keys))


def shard_view(c, s: int, rows: int):
    """Shard ``s``'s sub-pool: rows ``[s·rows, (s+1)·rows)`` of a pool
    leaf (or both tensors of an int8 QTensor)."""
    from kata_xpu_device_plugin_tpu_torch.ops.quant import QTensor

    if isinstance(c, QTensor):
        return QTensor(c.q[:, s * rows:(s + 1) * rows],
                       c.scale[:, s * rows:(s + 1) * rows])
    return c[:, s * rows:(s + 1) * rows]


def owned_keys(tables, pos, lo: int, nbl: int, bs: int, keys: int) -> float:
    """Keys of the tiles a shard holding global blocks ``[lo, lo + nbl)``
    reads for these lanes: the keys up to each lane's position (a dead
    lane's view to its end) in the tiles whose table entry it holds."""
    import torch

    p = pos.clamp(max=keys - 1).long()
    key = torch.arange(keys, device=pos.device)
    blk = torch.gather(tables.long(), 1, (key // bs).expand(len(p), -1))
    mine = (blk >= lo) & (blk < lo + nbl) & (key[None, :] <= p[:, None])
    return float(mine.sum())


def shard_case(name, B, H, KV, D, bs, tp, quantized, timed=False):
    """The shard-local paged decode form (K2) on every shard of a
    block-sharded pool (:func:`shard_inputs`): each shard's ``(acc, m,
    l)`` against the plain shard-local version within
    ``decode_attn.shard_stats_tolerance`` and its normalised output within
    ``kernel_tolerance``; a relaunch bit-identical; the merged output
    bit-equal to the unsharded kernel for the two lanes whose blocks lie on
    one shard, and within ``kernel_tolerance`` of the plain version for
    every live lane. ``timed``: shard 0's launch by CUDA-graph replay
    beside its plain version and its bound (the bytes of the tiles it
    holds), every shard's launch and the merge together, and the unsharded
    kernel on the same pool and tables."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops import attention
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        from_stat_rows,
        paged_decode_attention,
        paged_decode_reference,
        paged_decode_shard_stats,
        paged_decode_split_reference,
        shard_stats_tolerance,
    )

    q, k, v, tables, pos, nbl, kw = shard_inputs(B, H, KV, D, bs, tp, quantized)
    rows = nbl * bs
    parts, worst = [], {"stats_m_err": 0.0, "stats_l_err_over_bound": 0.0,
                        "empty_rows": 0}
    norm_cases = []
    for s in range(tp):
        ks, vs = shard_view(k, s, rows), shard_view(v, s, rows)
        shard = dict(shard_lo=s * nbl, shard_blocks=nbl)
        got = paged_decode_shard_stats(q, ks, vs, tables, pos, **kw, **shard)
        again = paged_decode_shard_stats(q, ks, vs, tables, pos, **kw, **shard)
        want = paged_decode_split_reference(q, ks, vs, tables, pos, **kw,
                                            **shard, return_stats=True)
        mag = paged_decode_split_reference(q.float(), ks, shard_view(
            v_abs(v), s, rows), tables, pos, **kw, **shard, return_stats=True)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            relaunch_equal(f"{name} shard {s}", _bits(a), _bits(b))
        live = slice(0, B - 1)  # the dead lane's rows are garbage on both
        res = shard_stats_tolerance([t[live] for t in got],
                                    [t[live] for t in want], q, ks)
        if not res["ok"]:
            raise AssertionError(f"{name} shard {s}: statistics {res}")
        worst["stats_m_err"] = max(worst["stats_m_err"], res["m_err"])
        worst["stats_l_err_over_bound"] = max(worst["stats_l_err_over_bound"],
                                              res["l_err_over_bound"])
        worst["empty_rows"] += res["empty_rows"]
        held = from_stat_rows(want[1][live] > attention.NEG_INF / 2, 1)
        norm = [t[0][live][held] / from_stat_rows(t[2][live], 1)[held][..., None]
                for t in (got, want, mag)]
        norm_cases.append(check(f"{name} shard {s} normalised",
                                norm[0].to(torch.bfloat16), norm[1], norm[2]))
        parts.append(got)
        del want, mag
    merged = attention.merge_shard_stats(parts, q.dtype)
    whole = paged_decode_attention(q, k, v, tables, pos, **kw)
    torch.cuda.synchronize()
    one_shard_bit_equal = torch.equal(_bits(merged[:2]), _bits(whole[:2]))
    if not one_shard_bit_equal:
        raise AssertionError(f"{name}: lanes on one shard differ from the "
                             "unsharded kernel")
    ref = paged_decode_reference(q, k, v, tables, pos, **kw)
    mag = paged_decode_reference(q.float(), k, v_abs(v), tables, pos, **kw)
    res = check(name, merged[:-1], ref[:-1], mag[:-1])
    res.update(worst, lanes_on_one_shard_bit_equal=True,
               normalised_max_err_over_bound=max(
                   c["max_err_over_bound"] for c in norm_cases))
    del ref, mag
    if timed:
        ks, vs = shard_view(k, 0, rows), shard_view(v, 0, rows)
        shard = dict(shard_lo=0, shard_blocks=nbl)
        call = lambda: paged_decode_shard_stats(  # noqa: E731
            q, ks, vs, tables, pos, **kw, **shard)
        res["ms"] = graph_ms(call, 20)
        res["call_ms"] = time_ms(call, 20)
        res["plain_ms"] = time_ms(lambda: paged_decode_split_reference(
            q, ks, vs, tables, pos, **kw, **shard, return_stats=True), 3, 1)
        res["library_ms"] = None  # no single PyTorch call computes it

        def all_shards():
            return attention.merge_shard_stats(
                [paged_decode_shard_stats(q, shard_view(k, s, rows),
                                          shard_view(v, s, rows), tables, pos,
                                          **kw, shard_lo=s * nbl,
                                          shard_blocks=nbl)
                 for s in range(tp)], q.dtype)

        res["all_shards_and_merge_ms"] = graph_ms(all_shards, 10)
        res["unsharded_ms"] = graph_ms(
            lambda: paged_decode_attention(q, k, v, tables, pos, **kw), 20)
        nb = tables.shape[1]
        # The bound counts every lane the kernel computes, the dead one
        # included (its rows are computed and then dropped by the caller);
        # the live lanes' share is printed beside it.
        mine = owned_keys(tables, pos, 0, nbl, bs, kw["paged_len"])
        live = owned_keys(tables[:-1], pos[:-1], 0, nbl, bs, kw["paged_len"])
        # The statistics are fp32: acc [B, H, D], m and l [B, H].
        bound = decode_bound(mine, B, 1, H, KV, D, nb, quantized,
                             4.0 * H * D * mine, out_bytes=B * H * (4 * D + 8))
        live_bound = decode_bound(live, B - 1, 1, H, KV, D, nb, quantized,
                                  4.0 * H * D * live,
                                  out_bytes=(B - 1) * H * (4 * D + 8))
        res.update(bound, owned_keys=mine, live_owned_keys=live,
                   live_bound_ms=live_bound["bound_ms"],
                   all_keys=float((pos.clamp(max=kw["paged_len"] - 1) + 1).sum()))
    emit("check", kernel="paged_decode_shard", B=B, H=H, KV=KV, D=D, bs=bs,
         tp=tp, int8=quantized, pos=pos.tolist(), **res)
    return res


def tp_crosscheck(params, cfg, prompt, tp: int, layout: str) -> dict:
    """One request through a tp server's forward (``tp_serving_params``:
    per-shard flash, the sums across shards) against the tp=1 kernel path
    and the plain path: the prefill's last-position logits, then the first
    decode step's from the tp=1 prefill's caches, through the layout's TP
    form of the paged kernel (over a pool of ``tp`` sub-pools, the
    request's blocks dealt across them, under "blocks"; over the slotted
    arena under "heads"). Each within LOGIT_BOUND x the plain logits' RMS
    of the plain path's, as the serving crosscheck holds the tp=1 path;
    the distance to the tp=1 kernel path is printed."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest.kv_arena import (
        SCRATCH_BLOCK,
        KVPool,
        pool_write_seq,
        table_tensor,
    )
    from kata_xpu_device_plugin_tpu_torch.guest.tp_serving import ServingMesh
    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        forward,
        prefill_batch,
        tp_serving_params,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    ref = attention.reference_attention
    max_len, bs = SERVE_KW["max_len"], 16
    mesh = ServingMesh.for_config(cfg, tp, "cuda")
    tparams = tp_serving_params(params, cfg, mesh)
    n = len(prompt)
    pad = next(b for b in SERVE_KW["prefill_buckets"] if b >= n)
    toks = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    toks[0, :n] = torch.from_numpy(np.asarray(prompt, np.int32))
    tl = torch.tensor([n], dtype=torch.int32)
    logits = {}
    for name, p_, fn in (("tp", tparams, None), ("tp1", params, None),
                         ("plain", params, ref)):
        caches, logits[name], pos = prefill_batch(
            p_, toks, cfg, max_len, tl, attn_fn=fn, kv_quantized=True)
        if name == "tp1":
            base = caches
    first = torch.argmax(logits["tp1"], -1).to(torch.int32)[:, None]
    paged = layout == "blocks"
    if paged:
        pool = KVPool(cfg, 64 * tp * bs, bs, kv_quant=True, shards=tp,
                      device="cuda")
        blocks = pool.try_alloc(-(-(n + 1) // bs))
        pool_write_seq(pool.arena, base, 0,
                       table_tensor(blocks, torch.device("cuda")), bs)
        bt = np.full((1, max_len // bs), SCRATCH_BLOCK, np.int32)
        bt[0, :len(blocks)] = blocks
        extra = dict(block_tables=torch.from_numpy(bt).cuda(), block_size=bs,
                     paged_len=max_len)
        arena = pool.arena
    else:
        extra, arena = {}, base

    def clone(c):
        return tuple(type(x)(*(t.clone() for t in x)) for x in c)

    def step(p_, fn, attn_fn, caches, kw):
        out, _ = forward(p_, first, cfg, attn_fn=attn_fn, positions=pos[:, None],
                         kv_caches=caches, cache_offset=pos, decode_kernel_fn=fn,
                         **kw)
        return out[:, -1]

    kfn = dict(paged=paged, block_size=bs, paged_len=max_len, arena_len=max_len,
               device="cuda")
    dec = {
        "tp": step(tparams, attention.make_decode_attn_fn(
            cfg, mesh=mesh, kv_layout=layout, **kfn), ref, clone(arena), extra),
        "tp1": step(params, attention.make_decode_attn_fn(cfg, **kfn), ref,
                    clone(arena), extra),
        "plain": step(params, None, ref, clone(base), {}),
    }
    row = {"tp": tp, "kv_layout": layout, "prompt_len": n,
           "logit_bound_x_rms": LOGIT_BOUND}
    for what, got in (("prefill", logits), ("decode", dec)):
        rms = float(got["plain"].square().mean().sqrt())
        row[f"{what}_logit_rms"] = rms
        row[f"{what}_err_x_rms"] = float((got["tp"] - got["plain"]).abs().max()) / rms
        row[f"{what}_tp1_err_x_rms"] = float(
            (got["tp1"] - got["plain"]).abs().max()) / rms
        row[f"{what}_vs_tp1_x_rms"] = float(
            (got["tp"] - got["tp1"]).abs().max()) / rms
    emit("tp_crosscheck", **row)
    if not (row["prefill_err_x_rms"] <= LOGIT_BOUND["prefill"]
            and row["decode_err_x_rms"] <= LOGIT_BOUND["decode"]):
        raise AssertionError(f"tp crosscheck out of the serving bound: {row}")
    return row


def tp_row(stats, wall, budgets, lens, launches) -> dict:
    """A tp server's serving row: :func:`serve_row`'s times with its shard
    counters."""
    row = {k: v for k, v in serve_row(stats, wall, budgets, lens,
                                      launches).items() if k in SIDE_KEYS}
    row.update({k: stats[k] for k in (
        "tp_degree", "kv_layout", "kv_pool_shards", "kv_pool_shard_occupancy",
        "kv_pool_shard_occupancy_peak", "kv_pool_occupancy_peak",
        "preemptions", "lanes_busy_peak", "arena_bytes")})
    return row


def phase_tp(params, cfg, seed: int = 0) -> tuple:
    """Tensor-parallel serving on one card (every shard on it): the K2
    kernel checks (:func:`shard_case` at the Gemma-2B decode shape, H=8,
    KV=1, D=256, and at Qwen2-7B's group of 7, H=28, KV=4, D=128; bf16 and
    int8; tiles 16 and 128; tp 2 and 4); then full-width Gemma-2B over the
    paged phase's pool and 32 requests at ``tp=1``, ``tp=2`` under heads
    (kv-replicated: 1 KV head), ``tp=2`` and ``tp=4`` under blocks, each
    counted (paged launches = rounds x chunk x layers x shards, through the
    shard-local form under blocks) with its tokens against tp=1's and the
    plain top-2 margin where they first part (row-parallel bf16 partial
    sums round otherwise than one GEMM, so equality is not expected);
    ``graph_check`` of a tp=2 blocks chunk; :func:`tp_crosscheck` of each
    tp run's layout and degree; then Qwen2-7B (4 of 28 layers)
    at tp=2 under heads, its KV heads split (2 a shard, group 7), beside
    tp=1. Returns the serving launches and the K2 check cases."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models import (
        fuse_decoder_params,
        init_params,
    )

    cases = []
    for model, (H, KV, D) in (("gemma2b", (8, 1, 256)), ("qwen2-7b", (28, 4, 128))):
        for quantized in (True, False):
            for bs in (16, 128):
                for tp in (2, 4):
                    timed = (model == "gemma2b" and quantized and bs == 16
                             and tp == 2)
                    kind = "int8" if quantized else "bf16"
                    cases.append(shard_case(f"{model} {kind} bs{bs} tp{tp}", 16,
                                            H, KV, D, bs, tp, quantized,
                                            timed=timed))
    prompts, budgets, lens = phase_requests(32, cfg.vocab_size, seed)
    launches = {}
    srv = GenerationServer(params, cfg, **PAGED_KW, **SERVE_KW)
    outs1, wall, runs, stats = run_requests(srv, prompts, budgets)
    del srv
    rows = {"tp1": tp_row(stats, wall, budgets, lens, runs)}
    for name, tp, layout in TP_RUNS:
        srv = GenerationServer(params, cfg, **PAGED_KW, **SERVE_KW, tp=tp,
                               kv_layout=layout)
        outs, wall, runs, stats = run_requests(srv, prompts, budgets)
        del srv
        torch.cuda.empty_cache()
        shards = tp if layout == "blocks" else 1
        if (stats["tp_degree"], stats["kv_pool_shards"]) != (tp, shards) or len(
                stats["kv_pool_shard_occupancy"]) != tp:
            raise AssertionError(f"{name}: {stats}")
        for k_, n in runs.items():
            launches[k_] = launches.get(k_, 0) + n
        rows[name] = dict(
            tp_row(stats, wall, budgets, lens, runs),
            token_match_vs_tp1=token_match(outs, outs1, budgets),
            first_difference_vs_tp1=first_difference_margin(
                params, cfg, prompts, outs, outs1))
    graph = graph_check(params, cfg, dict(**PAGED_KW, **SERVE_KW, tp=2,
                                          kv_layout="blocks"))
    emit("tp", model="gemma_2b", config=dict(PAGED_KW, **SERVE_KW),
         devices=torch.cuda.device_count(), **rows,
         graph_check_tp2_blocks=graph["outputs_bit_equal"]
         and graph["arena_bit_equal"])
    for _name, tp, layout in TP_RUNS:
        tp_crosscheck(params, cfg, prompts[0], tp, layout)
    qcfg, reduced = family_config("qwen2_7b", 4)
    qparams = fuse_decoder_params(
        init_params(qcfg, seed=seed, device="cuda", dtype=torch.bfloat16))
    qprompts, qbudgets, qlens = phase_requests(16, qcfg.vocab_size, seed)
    side = {}
    for name, tp in (("tp1", 1), ("tp2_heads", 2)):
        srv = GenerationServer(qparams, qcfg, **PAGED_KW, **SERVE_KW, tp=tp)
        side[name] = run_requests(srv, qprompts, qbudgets)
        del srv
    for k_, n in side["tp2_heads"][2].items():
        launches[k_] = launches.get(k_, 0) + n
    emit("tp_qwen2", model="qwen2_7b", reduced=reduced, **{
        name: tp_row(st, w, qbudgets, qlens, ln)
        for name, (_o, w, ln, st) in side.items()},
        token_match_tp2_vs_tp1=token_match(side["tp2_heads"][0],
                                           side["tp1"][0], qbudgets),
        first_difference_vs_tp1=first_difference_margin(
            qparams, qcfg, qprompts, side["tp2_heads"][0], side["tp1"][0]))
    del qparams
    torch.cuda.empty_cache()
    return launches, cases


# ----- crash tolerance ----------------------------------------------------------

RESILIENCE_DIR = os.path.join(HERE, "build", "resilience")
# The faulted run's schedule: a transient fault at four seams and a fence
# hang, each crossing counted from the server's construction. The counts
# depend only on the requests' lengths and budgets: fault-free, the warm-up
# request crosses decode_dispatch and fence twice, the others once; the 32
# requests then bring them to 49, 49, 21, 21 and 125 (pool_alloc), counted
# by a CPU run of the same schedule at test widths.
RESILIENCE_FAULTS = (("decode_dispatch", 16), ("prefill", 12),
                     ("admission_commit", 15), ("pool_alloc", 90),
                     ("fence", 36, "hang"))
RESILIENCE_KW = dict(checkpoint_rounds=4, fence_timeout_s=30.0,
                     recovery_backoff_s=0.0, strict=True)


def instrument_recovery(srv) -> dict:
    """Wrap ``srv``'s supervisor to record, for this script's readings:
    each recovery's fault kind and its latency to the next retired chunk,
    each checkpoint's ms and host bytes, the rids restored from a
    checkpoint (apart, those never replayed from their prompt), and those
    admitted before the first fault."""
    rec = {"recoveries": [], "checkpoints": [], "restored": set(),
           "restored_first": set(), "before_fault": None}
    recover, retire = srv._recover, srv._retire
    checkpoint, restore = srv._checkpoint, srv._restore_lane

    def _recover(exc):
        if rec["before_fault"] is None:
            lanes = [r.rid for r in srv._slot_req if r is not None]
            rec["before_fault"] = set(srv._results) | set(lanes)
        rec["recoveries"].append({"kind": type(exc).__name__,
                                  "t": time.perf_counter(), "ms": None})
        return recover(exc)

    def _retire(fl):
        out = retire(fl)
        for r in rec["recoveries"]:
            if r["ms"] is None:
                r["ms"] = round((time.perf_counter() - r["t"]) * 1e3, 3)
        return out

    def _checkpoint():  # torchguard: allow(TL004) the server's checkpoint waits for its copies itself (a watchdog-bounded fence)
        t0 = time.perf_counter()
        checkpoint()
        nbytes = sum(t.numel() * t.element_size() for e in srv._ckpt.values()
                     for c in e.kv for t in (c if isinstance(c, tuple) else (c,)))
        rec["checkpoints"].append({"ms": round((time.perf_counter() - t0) * 1e3, 3),
                                   "bytes": nbytes, "lanes": len(srv._ckpt)})

    def _restore(b, entry):
        ok = restore(b, entry)
        if ok:
            rec["restored"].add(entry.req.rid)
            if not entry.req.replays:  # never replayed from its prompt
                rec["restored_first"].add(entry.req.rid)
        return ok

    srv._recover, srv._retire = _recover, _retire
    srv._checkpoint, srv._restore_lane = _checkpoint, _restore
    return rec


def faulted_run(srv, prompts, budgets, counters):
    """:func:`warm_server`, then every request submitted, the kernels'
    launch counts set to 0 and the server drained. Returns the outputs by
    request (in submit order; None for a failed one), the rids, the wall
    time, the launches, the graph's replays over the run and the stats."""
    import torch

    warm_server(srv)
    rids = [srv.submit(p, int(b)) for p, b in zip(prompts, budgets)]
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    replays0 = srv.stats()["decode_graph_replays"]
    t0 = time.perf_counter()
    results = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = srv.stats()
    outs = [results.get(rid) for rid in rids]
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    return outs, rids, wall, launches, stats["decode_graph_replays"] - replays0, stats


def phase_resilience(params, cfg, smi: str, seed: int = 0) -> dict:
    """Crash-tolerant serving on the card, full-width Gemma-2B on the paged
    phase's server (16 lanes, a pool of 8000 tokens in blocks of 16, int8
    KV, overlapped rounds, telemetry on, ``strict=True``) and its 32
    requests: a fault-free run, then the same requests under
    :data:`RESILIENCE_FAULTS` with ``checkpoint_rounds=4`` and a 30 s fence
    watchdog. Asserted: every rid in exactly one of the results and the
    failures (none fail here), one recovery for each fault fired (all of
    them), the requests restored from a checkpoint and admitted before the
    first fault bit-equal to the fault-free run (their rows re-land
    verbatim and a lane's arithmetic does not depend on its batch-mates),
    paged kernel launches = graph replays over the run x chunk x layers
    (counted through replays across the recoveries: the in-place reset
    keeps the graph, one capture in all, and the tripwire counts no compile
    and no reshard in the run), the decode backend unchanged,
    no strict-mode guard trip. Printed: the token match and the first
    parting's plain top-2 margin of the other requests (a replay may be
    admitted in another group, and bf16 GEMMs at another batch size round
    differently), recovery latency by fault kind (fault to the next retired
    chunk), checkpoint ms and host bytes, tok/s faulted against fault-free.
    Then a quarantine drill: a poison request whose admission faults twice
    fails on its own (``quarantine_after=2``) while a request of another
    bucket, blamed never, finishes bit-equal to its fault-free tokens.
    Then ``tp=4`` under the blocks layout, fault-free and under
    ``decode_dispatch:<n>:chip_loss:1``: a ``tp_degraded`` event 4 -> 2,
    shard-local kernel launches = chunk x layers x (4 x replays before the
    shrink + 2 x dispatches after), one new capture, none failed; printed:
    the token match against the fault-free tp=4 run, and the shrink's
    re-split and capture ms; and the card's reserved bytes once every
    server of the phase is gone, against before the first (graph pools
    released)."""
    import gc
    import shutil

    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import obs
    from kata_xpu_device_plugin_tpu_torch.compat import torchapi
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.guest.resilience import (
        FaultInjector,
        FaultSpec,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import attention
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        paged_decode_attention,
        paged_decode_shard_stats,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward

    shutil.rmtree(RESILIENCE_DIR, ignore_errors=True)
    os.makedirs(RESILIENCE_DIR)
    prev_flight = os.environ.get("KATATPU_FLIGHT_DIR")
    os.environ["KATATPU_FLIGHT_DIR"] = os.path.join(RESILIENCE_DIR, "flight")
    sink_path = os.path.join(RESILIENCE_DIR, "events.jsonl")
    sink = obs.EventSink(sink_path)
    prev_sink = obs.set_default_sink(sink)
    counters = {"flash_fwd": flash_forward, "paged_decode": paged_decode_attention,
                "paged_decode_shard": paged_decode_shard_stats}
    prompts, budgets, lens = phase_requests(32, cfg.vocab_size, seed)
    kw = dict(**PAGED_KW, **SERVE_KW)
    steps, layers = SERVE_KW["chunk"], cfg.n_layers
    launches: dict = {}

    def reserved() -> int:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    reserved0 = reserved()

    def add(runs):
        for k, n in runs.items():
            launches[k] = launches.get(k, 0) + n

    try:
        clean = GenerationServer(params, cfg, strict=True, **kw)
        ref, _, wall0, _, _, st0 = faulted_run(clean, prompts, budgets, counters)
        del clean
        faults = [FaultSpec(*f) for f in RESILIENCE_FAULTS]
        srv = GenerationServer(params, cfg, fault_injector=FaultInjector(faults),
                               **RESILIENCE_KW, **kw)
        rec = instrument_recovery(srv)
        got, rids, wall, runs, replays, st = faulted_run(srv, prompts, budgets,
                                                         counters)
        add(runs)
        fired = list(srv._inj.fired)
        fails = srv.failures()
        served = {r for r, o in zip(rids, got) if o is not None}
        if served | set(fails) != set(rids) or served & set(fails) or fails:
            raise AssertionError(f"lost or failed requests: {sorted(fails)}, "
                                 f"{len(served)} of {len(rids)} served")
        if len(fired) != len(RESILIENCE_FAULTS) or st["recoveries"] != len(fired):
            raise AssertionError(f"fired {fired}, recoveries {st['recoveries']}")
        if (st["decode_backend"], st["decode_backend_reason"]) != (
                attention.BACKEND_PAGED, ""):
            raise AssertionError(f"decode left the kernel: {st['decode_backend']}")
        if (st["decode_graph_captures"], st["steady_state_compiles"],
                st["steady_state_reshards"]) != (1, 0, 0):
            raise AssertionError(
                f"a transient recovery captured again or moved a tensor: "
                f"{st['decode_graph_captures']} captures, tripwire "
                f"{st['steady_state_compiles']}/{st['steady_state_reshards']}")
        if runs.get("paged_decode") != replays * steps * layers:
            raise AssertionError(f"paged launches {runs} against {replays} "
                                 f"replays x {steps} x {layers}")
        if torchapi.strict_depth() or torch.cuda.get_sync_debug_mode():
            raise AssertionError("strict mode left its guard on")
        # Positions in submit order of the requests restored from a
        # checkpoint, never replayed, admitted before the first fault.
        clean_ids = [i for i, r in enumerate(rids) if r in rec["restored_first"]
                     and r in rec["before_fault"]]
        if not clean_ids:
            raise AssertionError("no request admitted before the first fault "
                                 "was restored from a checkpoint")
        for i in clean_ids:
            if not np.array_equal(got[i], ref[i]):
                raise AssertionError(f"checkpoint-restored request {rids[i]} "
                                     "differs from the fault-free run")
        others = [i for i in range(len(rids)) if i not in clean_ids]
        by_kind: dict = {}
        for r in rec["recoveries"]:
            by_kind.setdefault(r["kind"], []).append(r["ms"])
        generated = int(sum(budgets))
        main = dict(
            fired=[list(f) for f in fired], recoveries=st["recoveries"],
            device_stalls=st["device_stalls"], checkpoints=st["checkpoints"],
            restored_before_first_fault=len(clean_ids),
            restored_all=len(rec["restored"]),
            token_match_others=token_match([got[r] for r in others],
                                           [ref[r] for r in others],
                                           [budgets[r] for r in others]),
            first_difference_others=first_difference_margin(
                params, cfg, [prompts[r] for r in others],
                [got[r] for r in others], [ref[r] for r in others]),
            recovery_ms_by_kind=by_kind,
            checkpoint_ms=[c["ms"] for c in rec["checkpoints"]],
            checkpoint_bytes=[c["bytes"] for c in rec["checkpoints"]],
            checkpoint_lanes=[c["lanes"] for c in rec["checkpoints"]],
            tok_s=round(generated / wall, 2), tok_s_fault_free=round(
                generated / wall0, 2),
            rounds=st["rounds"], rounds_fault_free=st0["rounds"],
            replays=replays, launches=runs,
            preemptions=st["preemptions"], captures=st["decode_graph_captures"])
        del srv
        # The quarantine drill: the poison request (bucket 128) and one of
        # bucket 1024 admit in one pass, two forwards; both of the poison's
        # faults blame it alone.
        drill_p = [prompts[0][:100], np.resize(prompts[1], 600).astype(np.int32)]
        solo = GenerationServer(params, cfg, strict=True, **kw)
        solo.submit(drill_p[1], 32)
        want = list(solo.run().values())[0]
        del solo
        drill = GenerationServer(
            params, cfg, quarantine_after=2, fault_injector=FaultInjector(
                [FaultSpec("prefill", 0), FaultSpec("prefill", 1)]),
            **RESILIENCE_KW, **kw)
        poison, other = (drill.submit(p, 32) for p in drill_p)
        out = drill.run()
        if list(drill.failures()) != [poison] or not np.array_equal(
                out.get(other), want) or drill.stats()["quarantined"] != 1:
            raise AssertionError(f"quarantine drill: failures {drill.failures()}, "
                                 f"results {sorted(out)}")
        del drill
        # The shrink: tp=4 blocks, fault-free, then a chip lost mid-run.
        tp_kw = dict(kw, tp=4, kv_layout="blocks")
        clean4 = GenerationServer(params, cfg, **tp_kw)
        ref4, _, wall4, _, _, _ = faulted_run(clean4, prompts, budgets, counters)
        del clean4
        torch.cuda.empty_cache()
        shrink = GenerationServer(params, cfg, fault_injector=FaultInjector(
            [FaultSpec("decode_dispatch", 20, "chip_loss", 1)]), **tp_kw,
            **RESILIENCE_KW)
        rec4 = instrument_recovery(shrink)
        got4, _, wall_s, runs4, replays4, st4 = faulted_run(
            shrink, prompts, budgets, counters)
        add(runs4)
        # The new graph's first dispatch runs eagerly; its second captures
        # and replays.
        new_replays = shrink._decode.replays
        old_replays = replays4 - new_replays
        want_k2 = steps * layers * (4 * old_replays + 2 * (new_replays + 1))
        deg = [e for e in obs.read_events(sink_path)
               if e["name"] == "tp_degraded" and e["server"] == shrink._label]
        if (len(deg) != 1 or (deg[0]["old_tp"], deg[0]["tp"]) != (4, 2)
                or st4["tp_degree"] != 2 or shrink.failures()
                or any(o is None for o in got4)):
            raise AssertionError(f"shrink: {deg}, tp {st4['tp_degree']}, "
                                 f"failures {shrink.failures()}")
        if st4["decode_graph_captures"] != 2 or runs4.get(
                "paged_decode_shard") != want_k2 or "paged_decode" in runs4:
            raise AssertionError(f"shrink launches {runs4} against {want_k2}; "
                                 f"captures {st4['decode_graph_captures']}")
        if (st4["decode_backend"], st4["kv_pool_shards"]) != (
                attention.BACKEND_PAGED, 2):
            raise AssertionError(f"after the shrink: {st4['decode_backend']}, "
                                 f"{st4['kv_pool_shards']} shards")
        shrink_row = dict(
            fired=[list(f) for f in shrink._inj.fired], tp=st4["tp_degree"],
            shards_before_after=[4, 2], replays_before=old_replays,
            dispatches_after=new_replays + 1, launches=runs4,
            resplit_ms=round(deg[0]["resplit_s"] * 1e3, 3),
            capture_ms=round(st4["decode_graph_capture_s"] * 1e3, 3),
            recovery_ms=[r["ms"] for r in rec4["recoveries"]],
            token_match_vs_tp4=token_match(got4, ref4, budgets),
            first_difference_vs_tp4=first_difference_margin(
                params, cfg, prompts, got4, ref4),
            tok_s=round(generated / wall_s, 2),
            tok_s_fault_free=round(generated / wall4, 2))
        del shrink
        teardown = reserved() - reserved0
    finally:
        obs.set_default_sink(prev_sink)
        sink.close()
        if prev_flight is None:
            os.environ.pop("KATATPU_FLIGHT_DIR", None)
        else:
            os.environ["KATATPU_FLIGHT_DIR"] = prev_flight
    events = obs.read_events(sink_path)
    trips = [e for e in events if e["name"] == "guard_trip"]
    if trips:
        raise AssertionError(f"strict mode tripped: {trips[:2]}")
    emit("resilience", model="gemma_2b", card=smi, config=dict(
        PAGED_KW, **SERVE_KW, **RESILIENCE_KW), faults=RESILIENCE_FAULTS,
        faulted=main, quarantine_drill=dict(
            poison=poison, other_bit_equal=True, quarantined=1),
        tp4_blocks_chip_loss=shrink_row,
        reserved_after_teardown_bytes=teardown, events={n: sum(e["name"] == n for e in events) for n in (
            "fault_injected", "device_stall", "recovery", "checkpoint",
            "tp_degraded", "request_failed")})
    return launches


def phase_generate(params, cfg, seed: int = 0, phase: str = "generate") -> dict:
    """``generate()`` under ``KATA_TPU_DECODE_KERNEL=1``: lock-step decode
    through the dense kernel, counted; then each layer's kernel call of the
    first decode step held against the plain version on the model's own q,
    k and v; then the run without the opt-in (the paged kernel over the
    slotted re-view) for the token-match fraction."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.constants import ENV_DECODE_KERNEL
    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        CUDA_PAD,
        _decode_scan,
        generate,
        prefill,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import attention
    from kata_xpu_device_plugin_tpu_torch.ops.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.flash import flash_forward

    B, S, steps = 8, 128, 64
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    kernels = {"flash_fwd": flash_forward, "paged_decode": paged_decode_attention,
               "dense_decode": decode_attention}

    def run():
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        toks = generate(params, prompt, cfg, steps)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0, {
            k: fn.launches for k, fn in kernels.items()}

    os.environ.pop(ENV_DECODE_KERNEL, None)
    plain_toks, plain_wall, plain_launches = run()
    os.environ[ENV_DECODE_KERNEL] = "1"
    try:
        toks, wall, launches = run()
        # The per-layer check: the first decode step again, by hand, with
        # the default dispatch wrapped.
        cases = []

        def checked(q, k, v, causal=True, q_offset=None, **kw):
            out = attention.flash_attention(q, k, v, causal=causal,
                                            q_offset=q_offset, **kw)
            if q_offset is not None:
                ref = attention.reference_attention(q, k, v, q_offset=q_offset)
                mag = attention.reference_attention(
                    q.float(), k.float(), v.abs().float(), q_offset=q_offset)
                cases.append(check("generate layer", out, ref, mag))
            return out

        caches, last, pos = prefill(  # the cache length generate() pads to
            params, torch.as_tensor(prompt, device="cuda"), cfg,
            -(-(S + steps) // CUDA_PAD) * CUDA_PAD)
        before = decode_attention.launches
        _decode_scan(params, caches, last, pos, cfg, 1, attn_fn=checked)
        checked_launches = decode_attention.launches - before
    finally:
        del os.environ[ENV_DECODE_KERNEL]
    want = {"flash_fwd": cfg.n_layers, "paged_decode": 0,
            "dense_decode": cfg.n_layers * (steps - 1)}
    emit(phase, layers=cfg.n_layers, H=cfg.n_heads, KV=cfg.n_kv_heads,
         D=cfg.head_dim, B=B, prompt=S, steps=steps, cache="bf16",
         wall_s=round(wall, 4), tok_s=round(B * steps / wall, 2),
         launches=launches, wall_without_opt_in_s=round(plain_wall, 4),
         launches_without_opt_in=plain_launches,
         token_match_vs_without_opt_in=float((toks == plain_toks).float().mean()),
         layers_checked=len(cases),
         layer_max_err_over_bound=max(c["max_err_over_bound"] for c in cases))
    if launches != want:
        raise AssertionError(f"generate launches {launches}, want {want}")
    if plain_launches["dense_decode"] or not plain_launches["paged_decode"]:
        raise AssertionError(f"without the opt-in: {plain_launches}")
    if len(cases) != cfg.n_layers or checked_launches != cfg.n_layers:
        raise AssertionError(f"generate crosscheck: {len(cases)} checks, "
                             f"{checked_launches} launches")
    if toks.shape != (B, steps) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("generate: bad tokens")
    return {k: v for k, v in launches.items() if v}


def phase_generate_qwen2(seed: int = 0) -> dict:
    """:func:`phase_generate` at Qwen2-7B's published widths with 4 of its
    28 layers: the dense decode kernel (and, without the opt-in, the paged
    kernel over the slotted re-view) at the group of 7."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models import (
        fuse_decoder_params,
        init_params,
        qwen2_7b,
    )

    cfg = qwen2_7b(n_layers=4)
    params = fuse_decoder_params(
        init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16))
    out = phase_generate(params, cfg, seed, phase="generate_qwen2")
    del params
    return out


# ----- speculative decoding and ring / cycle KV arenas -------------------------

# Drafts a verify round of configuration 13 (``speculative_k``).
SPEC_K = 4


def spec_requests(vocab: int, seed: int = 0):
    """Configuration 13's requests: 8 repetitive prompts (a random 64-token
    segment repeated out to 512-1000 tokens) and 8 random ones of 64-1000
    tokens, budgets 64-128, interleaved."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = []
    for i in range(16):
        if i % 2 == 0:
            seg = rng.integers(0, vocab, 64).astype(np.int32)
            prompts.append(np.resize(seg, int(rng.integers(512, 1001))))
        else:
            prompts.append(rng.integers(0, vocab, int(rng.integers(64, 1001)))
                           .astype(np.int32))
    budgets = rng.integers(64, 129, 16)
    return prompts, budgets


def spec_serve(srv, prompts, budgets, counts: dict) -> tuple:
    """Warm the server, then serve the requests with the launch counters set
    to 0 just before and read just after (added into ``counts``). Returns
    the outputs, the wall time, this run's launches and the stats with the
    run's rounds, tokens and drafts alone."""
    import torch

    kernels = counted_kernels()
    base = warm_server(srv)
    d0 = (srv._drafts_offered, srv._drafts_accepted)
    rids = [srv.submit(p, int(b)) for p, b in zip(prompts, budgets)]
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    for k, n in launches.items():
        counts[k] = counts.get(k, 0) + n
    outs = [res[r] for r in rids]
    for out, b in zip(outs, budgets):
        if len(out) != int(b) or not ((out >= 0) & (out < srv.cfg.vocab_size)).all():
            raise AssertionError(f"{len(out)} tokens for a budget of {b}, or "
                                 "a token out of the vocabulary")
    st = srv.stats()
    st = {**st, **{k: st[k] - base[k] for k in ("rounds", "tokens_emitted",
                                                "prefills")}}
    offered = srv._drafts_offered - d0[0]
    if srv.speculative_k:
        st["draft_acceptance"] = round(
            (srv._drafts_accepted - d0[1]) / offered, 4) if offered else 0.0
    return outs, wall, launches, st


def verify_attention_ms(cfg, B: int, max_len: int) -> dict:
    """One layer's plain attention at a verify round's shape (``[B, k+1]``
    queries at per-lane offsets over the int8 arena, dequantized as the
    server's verify does), by CUDA events; times the layers, a round."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops import attention
    from kata_xpu_device_plugin_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    g = torch.Generator(device="cuda").manual_seed(0)
    S = SPEC_K + 1

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    q = randn(B, S, cfg.n_heads, cfg.head_dim)
    ck = quantize_kv(randn(B, max_len, cfg.n_kv_heads, cfg.head_dim))
    cv = quantize_kv(randn(B, max_len, cfg.n_kv_heads, cfg.head_dim))
    pos = torch.from_numpy(np.linspace(100, max_len - S - 1, B).astype(
        np.int32)).cuda()

    def one():
        attention.cache_attention(q, dequantize_kv(ck, q.dtype),
                                  dequantize_kv(cv, q.dtype), q_offset=pos)

    ms = time_ms(one, 20)
    return {"shape": dict(B=B, S=S, H=cfg.n_heads, KV=cfg.n_kv_heads,
                          D=cfg.head_dim, keys=max_len),
            "layer_ms": round(ms, 5), "round_ms": round(ms * cfg.n_layers, 4)}


def spec_library_checks(params, cfg, seed: int = 0) -> dict:
    """``generate_speculative`` (n-gram, k=4) at the model's widths on the
    card against greedy ``generate`` on the same 2 prompts (one repetitive):
    the token match, and each request's first parting, which must be a
    flip (:func:`token_partings`)."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models import (
        generate,
        generate_speculative,
    )

    rng = np.random.default_rng(seed)
    seg = rng.integers(0, cfg.vocab_size, 64)
    prompt = np.stack([np.resize(seg, 256),
                       rng.integers(0, cfg.vocab_size, 256)]).astype(np.int32)
    t0 = time.perf_counter()
    spec = generate_speculative(params, prompt, cfg, 48, k=SPEC_K)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    greedy = generate(params, prompt, cfg, 48).cpu().numpy()
    part = token_partings(params, cfg, list(prompt), list(spec), list(greedy),
                          False)
    if not part["all_flips"]:
        raise AssertionError(f"generate_speculative parts from generate: {part}")
    return {"tokens_match": float((spec == greedy).mean()),
            "wall_s": round(spec_s, 4), "partings": part}


def ring_checks(params, cfg, prompts, max_len: int) -> dict:
    """For each prompt, one decode step from one prefill over the full int8
    arena and over its fold (the ring, or the cycle arena), logits within
    LOGIT_BOUND["decode"] x the RMS (the same keys, summed in slot order);
    on the first prompt, ``generate(..., ring_kv=True)`` against the full
    arena's ``generate`` (32 steps; a parting must be a flip) and the public ``decode(..., ring=True,
    return_state=True)`` from a folded prefill against
    ``generate(ring_kv=True)``'s tokens (the same calls: equal)."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        CUDA_PAD,
        decode,
        fold_prefill,
        forward,
        generate,
        prefill,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention

    def padded(prompt):
        p = prompt[None].astype(np.int32)
        S = p.shape[1]
        pad = -(-S // CUDA_PAD) * CUDA_PAD
        return p, S, pad, torch.nn.functional.pad(
            torch.from_numpy(p).long().cuda(), (0, pad - S))

    steps = []
    for prompt in prompts:
        p, S, pad, toks = padded(prompt)
        full, last, pos = prefill(params, toks, cfg, max_len, true_len=S,
                                  kv_quantized=True)
        folded = fold_prefill(full, pos, cfg, max_len)
        at = torch.full((1,), pos, dtype=torch.int32, device="cuda")
        step = {}
        for name, caches, ring_kv in (("full", full, False),
                                      ("ring", folded, True)):
            step[name] = forward(params, last[:, None], cfg,
                                 attn_fn=reference_attention,
                                 positions=at[:, None], kv_caches=caches,
                                 cache_offset=at, ring=ring_kv)[0]
        err = float((step["ring"] - step["full"]).abs().max())
        rms = float(step["full"].square().mean().sqrt())
        steps.append({"prompt_len": S, "logit_err": round(err, 6),
                      "logit_rms": round(rms, 5)})
        if not err <= LOGIT_BOUND["decode"] * rms:
            raise AssertionError(f"ring decode step {err} from the full "
                                 f"arena's (logit RMS {rms}, prompt of {S})")
        del full, folded
    p, S, pad, toks = padded(prompts[0])
    ring = generate(params, p, cfg, 32, max_len=max_len, ring_kv=True).cpu().numpy()
    full_toks = generate(params, p, cfg, 32, max_len=max_len).cpu().numpy()
    part = token_partings(params, cfg, [prompts[0]], list(ring),
                          list(full_toks), False)
    if not part["all_flips"]:
        raise AssertionError(f"generate(ring_kv=True) parts from the full arena: "
                             f"{part}")
    caches, last, pos = prefill(params, toks, cfg, pad, true_len=S)
    caches = fold_prefill(caches, pos, cfg, max_len)
    out, caches, last2, pos2 = decode(
        params, caches, last, torch.full((1,), pos, dtype=torch.int32,
                                         device="cuda"), cfg, 16,
        return_state=True, ring=True)
    same = bool((out.cpu().numpy() == ring[:, 1:17]).all())
    if not same or int(pos2[0]) != S + 16:
        raise AssertionError("decode(ring=True, return_state=True) is not "
                             "generate(ring_kv=True)'s continuation")
    return {"steps": steps,
            "generate_ring_vs_full_match": float((ring == full_toks).mean()),
            "partings": part, "decode_ring_equal_to_generate": same}


def ring_serve(name: str, layers, seed: int, counts: dict) -> list:
    """Configuration 13 (c)/(d): ``name`` at its published widths (``layers``
    the depth cut) over 4 prompts of 4200-6000 tokens, budgets 32, slotted
    (4 lanes, ``max_len`` 8192, int8 KV): the full arena, ``ring_kv=True``
    and ``ring_kv=True`` with ``speculative_k`` 4. Tokens against the full
    arena (a parting must be a flip), tok/s, arena bytes and their ratio.
    Returns the failures."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models import (
        fuse_decoder_params,
        init_params,
    )

    cfg, reduced = family_config(name, layers)
    params = fuse_decoder_params(
        init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16))
    rng = np.random.default_rng(seed)
    lens = rng.integers(4200, 6001, 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    budgets = np.full(4, 32)
    max_len = 8192
    kw = dict(max_batch=4, max_len=max_len, chunk=8,
              prefill_buckets=tuple(b for b in LONG_BUCKETS if b <= max_len))
    rows, outs = {}, {}
    for run, extra in (("full", {}), ("ring", dict(ring_kv=True)),
                       ("ring_spec", dict(ring_kv=True, speculative_k=SPEC_K,
                                          spec_opt_in=True))):
        srv = GenerationServer(params, cfg, **kw, **extra)
        outs[run], wall, launches, st = spec_serve(srv, prompts, budgets, counts)
        if launches.get("paged_decode") or "flash_fwd" not in launches:
            raise AssertionError(f"{name} {run}: launches {launches}")
        rows[run] = dict(tok_s=round(int(budgets.sum()) / wall, 2),
                         wall_s=round(wall, 4), rounds=st["rounds"],
                         arena_bytes=st["arena_bytes"], launches=launches,
                         decode_backend_reason=st["decode_backend_reason"],
                         **({"draft_acceptance": st["draft_acceptance"]}
                            if "draft_acceptance" in st else {}))
        del srv
        torch.cuda.empty_cache()
    failures = []
    for run in ("ring", "ring_spec"):
        rows[run]["token_match_vs_full"] = token_match(outs[run], outs["full"],
                                                       budgets)
        part = token_partings(params, cfg, prompts, outs[run], outs["full"],
                              True)
        rows[run]["partings"] = part
        if not part["all_flips"]:
            failures.append(f"{name} {run}: {part}")
        rows[run]["arena_ratio"] = round(
            rows[run]["arena_bytes"] / rows["full"]["arena_bytes"], 5)
    try:
        lib = ring_checks(params, cfg, prompts, max_len)
    except AssertionError as e:
        lib = {"failed": str(e)[:300]}
        failures.append(f"{name}: {e}")
    emit("spec_ring", model=name, reduced=reduced, max_len=max_len,
         prompt_lens=lens.tolist(), window_cycle=list(cfg.window_cycle),
         config=dict(kw, kv_quant="int8"), **rows, library=lib)
    del params
    torch.cuda.empty_cache()
    return failures


@contextlib.contextmanager
def recording_verify(srv, log: list):
    """While inside, each greedy verify round of ``srv`` also records, for
    every draft position of its live lanes, whether the target's greedy
    token differs from the draft, and the gap of the verify logits between
    the greedy token and the draft token over the logits' RMS there (read
    after the run). The server imports ``verify_step`` at each round, so
    the module attribute is what it calls; the wrapper adds a gather and a
    reduction over the logits to every round, so a timed run goes without
    it."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models import speculative

    real = speculative.verify_step

    def verify_step(params, caches, toks, pos, cfg, attn_fn=None, ring=False):
        logits, caches = speculative.verify_logits_step(
            params, caches, toks, pos, cfg, attn_fn=attn_fn, ring=ring)
        lg, drafts = logits[:, :-1], toks[:, 1:].long()
        greedy = torch.argmax(logits, -1).to(torch.int32)
        live = [b for b, r in enumerate(srv._slot_req) if r is not None]
        gap = lg.max(-1).values - lg.gather(-1, drafts[..., None])[..., 0]
        log.append(((greedy[:, :-1] != drafts)[live],
                    (gap / lg.square().mean(-1).sqrt())[live]))
        return greedy, caches

    speculative.verify_step = verify_step
    try:
        yield
    finally:
        speculative.verify_step = real


def draft_agreement(log: list) -> dict:
    """Over every draft position :func:`recording_verify` saw: the share
    where the target's greedy token is the draft, and the largest gap over
    the logit RMS of a disagreement."""
    import torch

    dis = torch.cat([d.reshape(-1) for d, _r in log])
    rel = torch.cat([r.reshape(-1) for _d, r in log])
    return {"positions": int(dis.numel()),
            "agree": round(1 - int(dis.sum()) / max(int(dis.numel()), 1), 4),
            "max_disagreement_gap_x_rms": round(float(rel[dis].max()), 5)
            if bool(dis.any()) else 0.0}


def phase_spec(params, cfg, seed: int = 0) -> dict:
    """Configuration 13. (a) n-gram speculation on full-width Gemma-2B
    (slotted, 8 lanes, max_len 2048, int8 KV, k=4) on 8 requests (16
    before the guards phase joined: the script's time), beside
    the plain lock-step greedy server: tok/s, rounds, draft acceptance,
    token match, the verify round's plain attention ms;
    ``generate_speculative`` against ``generate``. (b) the same server
    with ``self_draft(params, cfg, 2)``, then with the target as its own
    draft on 4 requests over a bf16 arena, the draft's dtype, beside the
    plain lock-step server over a bf16 arena: the raw acceptance of each,
    and, from a second, untimed run of the perfect draft
    (:func:`recording_verify`), the share of its draft positions whose
    draft is the verify's greedy token, which must be 0.9 or more. Each
    request's first parting from its plain server must be a bf16 flip
    (:func:`token_partings`). (c) Gemma-2-2B (:data:`FAMILY_GEMMA2_LAYERS`
    of 26 layers) and (d)
    Mistral-7B (4 of 32 layers) with ``ring_kv`` (:func:`ring_serve`).
    Launches: the prefills' flash forward (row 1), the plain comparison
    servers' paged decode (row 5); verify spans, drafts and ring reads take
    the plain attention (the JAX rule)."""
    import numpy as np

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models import self_draft

    counts: dict = {}
    prompts, budgets = spec_requests(cfg.vocab_size, seed)
    base = dict(max_batch=8, **SERVE_KW)
    rows, plain = {}, {}
    for key, quantized, n in (("plain_lockstep", True, 8),
                              ("plain_lockstep_bf16", False, 4)):
        outs, wall, launches, st = spec_serve(
            GenerationServer(params, cfg, overlap=False, kv_quant=quantized,
                             **base), prompts[:n], budgets[:n], counts)
        if not launches.get("paged_decode"):
            raise AssertionError(f"the plain server left the paged kernel: "
                                 f"{launches}")
        plain[quantized] = outs
        rows[key] = dict(requests=n, rounds=st["rounds"], launches=launches,
                         tok_s=round(int(budgets[:n].sum()) / wall, 2))
    failures = []
    # A draft's arena is bf16, as in the JAX server: only over a bf16 target
    # arena is the target its own perfect draft (over an int8 one the two
    # read differently rounded keys). Its drafts are the target's one-token
    # steps and the verify a [B, k+1] span: in bf16 on the card the two
    # round differently, so a near-tie flips.
    perfect = dict(draft=(params, cfg), kv_quant=False)
    for run, extra, n in (("ngram", {}, 8),
                          ("self_draft_2", dict(draft=self_draft(params, cfg, 2)), 8),
                          ("perfect_draft", perfect, 4)):
        srv = GenerationServer(params, cfg, speculative_k=SPEC_K,
                               spec_opt_in=True, **base, **extra)
        outs, wall, launches, st = spec_serve(srv, prompts[:n], budgets[:n],
                                              counts)
        del srv
        if launches.get("paged_decode") or "flash_fwd" not in launches:
            failures.append(f"{run}: launches {launches}")
        quantized = extra.get("kv_quant", True)
        part = token_partings(params, cfg, prompts[:n], outs, plain[quantized],
                              quantized)
        if not part["all_flips"]:
            failures.append(f"{run} parts from the plain server: {part}")
        rows[run] = dict(
            requests=n, tok_s=round(int(budgets[:n].sum()) / wall, 2),
            wall_s=round(wall, 4), rounds=st["rounds"],
            tokens_per_round=round((st["tokens_emitted"] - st["prefills"])
                                   / max(st["rounds"], 1), 3),
            draft_acceptance=st["draft_acceptance"], kv_quant=st["kv_quant"],
            ttft_p50_s=st["ttft_s"]["p50"], itl_p50_s=st["decode_token_s"]["p50"],
            token_match_vs_plain=token_match(outs, plain[quantized],
                                             budgets[:n]),
            partings=part, launches=launches)
    log: list = []
    srv = GenerationServer(params, cfg, speculative_k=SPEC_K, spec_opt_in=True,
                           **base, **perfect)
    with recording_verify(srv, log):
        spec_serve(srv, prompts[:4], budgets[:4], {})
    del srv
    agreement = rows["perfect_draft"]["draft_agreement"] = draft_agreement(log)
    if agreement["agree"] < 0.9:
        failures.append(f"perfect draft: {agreement}")
    emit("spec", model="gemma_2b", k=SPEC_K, config=dict(base, kv_quant="int8"),
         prompt_lens=[len(p) for p in prompts], budgets=budgets.tolist(),
         **rows, verify_attention=verify_attention_ms(cfg, 8, SERVE_KW["max_len"]),
         library=spec_library_checks(params, cfg, seed))
    failures += ring_serve("gemma2_2b", FAMILY_GEMMA2_LAYERS, seed, counts)
    failures += ring_serve("mistral_7b", 4, seed, counts)
    if failures:
        raise AssertionError("spec: " + "; ".join(failures))
    return counts


def train_flops_per_step(cfg, B: int, S: int) -> float:
    """Model FLOPs of one train step, the JAX package's bench convention
    (``bench.py`` ``measure_train``): 6 x matmul parameters x tokens
    (embedding gather excluded, untied unembedding included) plus causal
    attention 6 L B S^2 H Dh."""
    per_layer = (cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
                 + cfg.q_dim * cfg.d_model + 3 * cfg.d_model * cfg.d_ff)
    matmul_params = cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size
    attn = 6 * cfg.n_layers * B * S * S * cfg.n_heads * cfg.head_dim
    return 6.0 * matmul_params * B * S + attn


TRAIN_MODELS = {  # model -> (layers of the published depth, why cut)
    "llama3_8b": (32, "one card's memory"),
    "gemma_2b": (18, "the phase's share of the run's time"),
    "llama3_train_bench": (12, None),
}


def phase_train(model: str = "llama3_8b", n_layers: int = 8, steps: int = 6,
                seed: int = 0, profile: bool = False, phase: str = "train",
                B: int = 2, seq_len: int = 2047, remat: bool = False) -> dict:
    """``fit`` at ``model``'s published widths with ``n_layers`` of its
    layers on one batch of ``B`` windows of ``seq_len + 1`` tokens, seen
    every step. ``profile`` adds one more step under the profiler."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.ops import flash
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        TokenBatchLoader,
        fit,
        make_optimizer,
        make_train_step,
    )
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves

    cfg = getattr(models, model)(n_layers=n_layers)
    stream = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, B * (seq_len + 1)).astype(np.int32)
    loader = TokenBatchLoader(stream, batch=B, seq_len=seq_len, shuffle=False)
    init_state, step = make_train_step(cfg, make_optimizer(), remat=remat)
    stamps = []

    def on_step(_s, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = (flash.flash_forward, flash.flash_bwd_dq, flash.flash_bwd_dkv)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    state, losses = fit(init_state, step, loader, steps=steps, seed=seed,
                        on_step=on_step)
    launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                        (fn.launches for fn in kernels)))
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in leaves(state["params"]))
    if profile:
        batch = next(loader)
        profiled(f"{model} train step {steps + 1}, B={B}, S={seq_len + 1}",
                 lambda: step(state, batch))
    del state
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    p50 = float(np.median(step_s))
    tokens = B * (seq_len + 1)
    flops = train_flops_per_step(cfg, B, seq_len + 1)
    full, why = TRAIN_MODELS[model]
    emit(phase, model=model, n_layers=n_layers,
         reduced=f"n_layers={n_layers} (from {full}; {why})" if n_layers < full
         else None, params=n_params, remat=remat,
         B=B, S=seq_len + 1, head_dim=cfg.head_dim, steps=steps, losses=losses,
         first_step_s=stamps[0] - t0, step_s=step_s, step_p50_s=p50,
         tokens_per_s=tokens / p50, model_flops_per_step=flops,
         mfu=flops / p50 / PEAK_BF16_FLOPS, peak_mem_bytes=peak,
         device_mem_bytes=torch.cuda.get_device_properties(0).total_memory,
         launches=launches)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase} loss not finite and falling: {losses}")
    # Under remat each layer's forward runs again in the backward.
    want = dict.fromkeys(launches, steps * n_layers)
    want["flash_fwd"] *= 2 if remat else 1
    if launches != want:
        raise AssertionError(f"{phase} launches {launches}, want {want}")
    return launches


def train_crosscheck(model: str = "llama3_8b", seed: int = 1, n_layers: int = 2,
                     phase: str = "train_crosscheck") -> dict:
    """One ``next_token_loss`` backward at ``model``'s widths with
    ``n_layers`` layers, B=1, S=2048, through the kernels and through
    ``reference_attention``, from the same fp32 weights and tokens. On the
    kernel path each layer's forward (with lse) and backward kernel call is
    held against the plain version on its own inputs; the loss difference
    and the cosine of the whole gradient are printed, not bounded (random
    weights carry each layer's rounding on through the model)."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.models import init_params
    from kata_xpu_device_plugin_tpu_torch.models.transformer import next_token_loss
    from kata_xpu_device_plugin_tpu_torch.ops import flash
    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves

    checks = {"fwd": [], "bwd": []}

    class Checked(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = flash.flash_forward(q, k, v, return_lse=True)
            ref, ref_lse = flash.flash_reference(q, k, v)
            mag = reference_attention(q.float(), k.float(), v.abs().float())
            checks["fwd"].append({**check("train layer fwd", out, ref, mag),
                                  "lse_max_abs_err": check_lse("layer", lse, ref_lse)})
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            got = flash.flash_backward(q, k, v, out, lse, do)
            want = flash.flash_backward_reference(q, k, v, out, lse, do)
            mags = flash.backward_magnitudes(q, k, v, out, lse, do)
            checks["bwd"].append(check_grads("train layer bwd", got, want, mags))
            return got

    def checked_attn(q, k, v, causal=True, q_offset=None, **kw):
        assert causal and q_offset is None and not kw
        return Checked.apply(q, k, v)

    cfg = getattr(models, model)(n_layers=n_layers)
    params = init_params(cfg, seed=seed, device="cuda", dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, 2048))).cuda()
    xs = [p.requires_grad_() for p in leaves(params)]
    results = {}
    for name, fn in (("kernel", checked_attn), ("plain", reference_attention)):
        loss = next_token_loss(params, toks, cfg, attn_fn=fn)
        results[name] = (float(loss.detach()), torch.autograd.grad(loss, xs))
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    dot = sum(float((a.double() * b.double()).sum()) for a, b in zip(gk, gp))
    nk = math.sqrt(sum(float(a.double().square().sum()) for a in gk))
    np_ = math.sqrt(sum(float(b.double().square().sum()) for b in gp))
    row = {"model": model, "n_layers": n_layers, "B": 1, "S": 2048,
           "head_dim": cfg.head_dim, "loss_kernel": lk,
           "loss_plain": lp, "loss_diff": lk - lp, "grad_cosine": dot / (nk * np_),
           "layers_checked_fwd": len(checks["fwd"]),
           "layers_checked_bwd": len(checks["bwd"]),
           "fwd_max_err_over_bound": max(c["max_err_over_bound"] for c in checks["fwd"]),
           "lse_max_abs_err": max(c["lse_max_abs_err"] for c in checks["fwd"]),
           "bwd_max_err_over_bound": max(c[g]["max_err_over_bound"]
                                         for c in checks["bwd"] for g in c)}
    emit(phase, **row)
    if row["layers_checked_fwd"] != n_layers or row["layers_checked_bwd"] != n_layers:
        raise AssertionError(f"{phase} checked {row}")
    if not (math.isfinite(lk) and math.isfinite(row["grad_cosine"])):
        raise AssertionError(f"{phase} not finite: {row}")
    return row


SEQ_MODELS = {  # model -> (layers of the published depth, why cut)
    "llama3_8b": (32, "one card's memory"),
    "gemma2_2b": (26, "the side run's share of the phase's time"),
}


def ring_pairs(cfg, sp: int, S_loc: int) -> int:
    """The block pairs a ring of ``sp`` shards runs a forward over all of
    ``cfg``'s layers: each shard meets the shards at or below it, up to the
    window's last hop (``parallel.ring._ring_hops``)."""
    from kata_xpu_device_plugin_tpu_torch.parallel.ring import _ring_hops

    return sum(min(i, _ring_hops(sp, S_loc, cfg.layer_window(layer))) + 1
               for layer in range(cfg.n_layers) for i in range(sp))


def phase_seq(model: str = "llama3_8b", n_layers: int = 8, steps: int = 4,
              sp: int = 4, S: int = 8192, seed: int = 0, profile: bool = False,
              phase: str = "seq") -> dict:
    """Sequence-parallel training: ``make_train_step(cfg,
    mesh=seq_mesh(sp))`` and ``fit`` at ``model``'s published widths with
    ``n_layers`` of its layers on one batch of B=1 window of ``S`` tokens,
    seen every step; ring attention over ``sp`` shards of ``S / sp``
    tokens, every shard on the one card, each live block pair through the
    K1 kernels. Launch counts reset just before and read just after: the
    block forward and backward exactly ``steps`` x the ring's live pairs,
    self-attention's kernels never. The loss must be finite and fall."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.ops import flash
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        TokenBatchLoader,
        fit,
        make_optimizer,
        make_train_step,
        seq_mesh,
    )
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves

    cfg = getattr(models, model)(n_layers=n_layers)
    B, seq_len = 1, S - 1
    stream = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, B * (seq_len + 1)).astype(np.int32)
    loader = TokenBatchLoader(stream, batch=B, seq_len=seq_len, shuffle=False)
    init_state, step = make_train_step(cfg, make_optimizer(), mesh=seq_mesh(sp))
    stamps = []

    def on_step(_s, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {"flash_fwd_block": flash.flash_block_forward,
                "flash_bwd_dq_block": flash.flash_block_bwd_dq,
                "flash_bwd_dkv_block": flash.flash_block_bwd_dkv,
                "flash_fwd": flash.flash_forward, "flash_bwd_dq": flash.flash_bwd_dq,
                "flash_bwd_dkv": flash.flash_bwd_dkv}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state, losses = fit(init_state, step, loader, steps=steps, seed=seed,
                        on_step=on_step)
    counts = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in leaves(state["params"]))
    if profile:
        batch = next(loader)
        profiled(f"{model} seq step {steps + 1}, B={B}, S={S}, sp={sp}",
                 lambda: step(state, batch))
    del state
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    p50 = float(np.median(step_s))
    flops = train_flops_per_step(cfg, B, S)
    full, why = SEQ_MODELS[model]
    pairs = ring_pairs(cfg, sp, S // sp)
    emit(phase, model=model, n_layers=n_layers,
         reduced=f"n_layers={n_layers} (from {full}; {why})", params=n_params,
         B=B, S=S, sp=sp, S_loc=S // sp, head_dim=cfg.head_dim,
         windows=[cfg.layer_window(i) for i in range(n_layers)],
         block_pairs_a_step=pairs, steps=steps, losses=losses,
         first_step_s=stamps[0] - t0, step_s=step_s, step_p50_s=p50,
         tokens_per_s=B * S / p50, model_flops_per_step=flops,
         mfu=flops / p50 / PEAK_BF16_FLOPS, peak_mem_bytes=peak,
         device_mem_bytes=torch.cuda.get_device_properties(0).total_memory,
         launches=counts)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase} loss not finite and falling: {losses}")
    block = ("flash_fwd_block", "flash_bwd_dq_block", "flash_bwd_dkv_block")
    want = {**{k: steps * pairs for k in block},
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if counts != want:
        raise AssertionError(f"{phase} launches {counts}, want {want}")
    return {k: counts[k] for k in block}


@contextlib.contextmanager
def checking_blocks(checks: dict):
    """Within the block, each K1 call (``flash_block_forward`` and
    ``flash_block_backward``, which the block API's autograd function
    reaches through the module) is held against its plain version on its
    own inputs: the forward's live rows within ``kernel_tolerance`` and its
    lse within LSE_TOL, the backward within the bound
    ``backward_magnitudes`` derives with the dlse term."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops import flash

    fwd, bwd = flash.flash_block_forward, flash.flash_block_backward

    def checked_fwd(q, k, v, q_off, k_off, causal, window, softcap):
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = fwd(q, k, v, q_off, k_off, **kw)
        ref, ref_lse = flash.flash_reference(q, k, v, q_off=q_off, k_off=k_off, **kw)
        mag, _ = flash.flash_reference(q.float(), k.float(), v.abs().float(),
                                       q_off=q_off, k_off=k_off, **kw)
        live = flash.live_rows(q.shape[1], k.shape[1], causal, window, q_off,
                               k_off).to(q.device)
        checks["fwd"].append({**check("seq block fwd", out[:, live], ref[:, live],
                                      mag[:, live]),
                              "lse_max_abs_err": check_lse(
                                  "seq block", lse[:, :, live], ref_lse[:, :, live])})
        return out, lse

    def checked_bwd(q, k, v, out, lse, dout, dlse, q_off, k_off, causal, window,
                    softcap):
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_off=q_off, k_off=k_off)
        got = bwd(q, k, v, out, lse, dout, dlse, q_off, k_off, causal, window,
                  softcap)
        want = flash.flash_backward_reference(q, k, v, out, lse, dout, dlse=dlse,
                                              **kw)
        mags = flash.backward_magnitudes(q, k, v, out, lse, dout, dlse=dlse, **kw)
        checks["bwd"].append(check_grads("seq block bwd", got, want, mags))
        del want, mags
        torch.cuda.empty_cache()
        return got

    # The forward wrapper counts its launches through its module name, so
    # the count lands on the stand-in while it stands in; the backward's
    # land on flash_block_bwd_dq and flash_block_bwd_dkv.
    checked_fwd.launches = 0
    flash.flash_block_forward, flash.flash_block_backward = checked_fwd, checked_bwd
    try:
        yield
    finally:
        flash.flash_block_forward, flash.flash_block_backward = fwd, bwd


def seq_crosscheck(model: str = "llama3_8b", n_layers: int = 2, sp: int = 4,
                   S: int = 8192, seed: int = 1,
                   phase: str = "seq_crosscheck") -> dict:
    """The first train step at ``model``'s widths with ``n_layers`` layers,
    B=1, S tokens, from the same fp32 weights (seed) and tokens: at sp=4
    through the K1 kernels and at sp=1 through the flash kernel. At sp=4
    each K1 call is held against its plain version on its own inputs
    (:func:`checking_blocks`), and each layer's merged ring output against
    the plain ring on the same inputs within ``ring_tolerance`` and against
    the sp=1 flash kernel on the same inputs within the sum of the two
    kernels' bounds (the ring's 2^-6 W + 2 ulp and the flash kernel's 2^-7
    W + 2 ulp, each against the plain attention: ``kernel_tolerance`` with
    5 W covers both, the extra ulps included). The two steps' losses and
    gradient norms are printed beside each other, not bounded: a layer's
    rounding difference carries on through the random model."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.ops import flash
    from kata_xpu_device_plugin_tpu_torch.ops.attention import (
        kernel_tolerance,
        ring_tolerance,
    )
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        make_optimizer,
        make_ring_attention,
        make_train_step,
        seq_mesh,
    )

    cfg = getattr(models, model)(n_layers=n_layers)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, S))
    ring = make_ring_attention(seq_mesh(sp))
    plain = make_ring_attention(seq_mesh(sp), use_flash=False)
    checks = {"fwd": [], "bwd": [], "ring": [], "vs_sp1": []}

    def checked_ring(q, k, v, causal=True, q_offset=None, **kw):
        out = ring(q, k, v, causal=causal, q_offset=q_offset, **kw)
        with torch.no_grad():
            qd, kd, vd = q.detach(), k.detach(), v.detach()
            ref = plain(qd, kd, vd, **kw)
            mag = plain(qd.float(), kd.float(), vd.abs().float(), **kw)
            res = ring_tolerance(out.detach(), ref, mag)
            sp1 = flash.flash_forward(qd, kd, vd, True, kw.get("window", 0),
                                      kw.get("logits_softcap", 0.0))
            res1 = kernel_tolerance(out.detach(), sp1, 5.0 * mag)
        for name, r in (("ring", res), ("vs_sp1", res1)):
            if not r.pop("ok"):
                raise AssertionError(f"{phase} layer {name}: {r}")
            checks[name].append(r)
        return out

    rows = {}
    for name, mesh, attn in (("sp4", seq_mesh(sp), checked_ring),
                             ("sp1", None, None)):
        init_state, step = make_train_step(cfg, make_optimizer(), attn_fn=attn,
                                           aux_metrics=True, mesh=mesh)
        state = init_state(seed)
        with checking_blocks(checks) if name == "sp4" else contextlib.nullcontext():
            state, loss, aux = step(state, toks)
        rows[name] = (float(loss), float(aux["grad_norm"]))
        del state
        torch.cuda.empty_cache()
    (l4, g4), (l1, g1) = rows["sp4"], rows["sp1"]
    pairs = ring_pairs(cfg, sp, S // sp)
    row = {"model": model, "n_layers": n_layers, "B": 1, "S": S, "sp": sp,
           "loss_sp4": l4, "loss_sp1": l1, "loss_diff": l4 - l1,
           "grad_norm_sp4": g4, "grad_norm_sp1": g1,
           "grad_norm_rel_diff": (g4 - g1) / g1,
           "blocks_checked_fwd": len(checks["fwd"]),
           "blocks_checked_bwd": len(checks["bwd"]),
           "block_fwd_max_err_over_bound": max(
               c["max_err_over_bound"] for c in checks["fwd"]),
           "block_lse_max_abs_err": max(c["lse_max_abs_err"] for c in checks["fwd"]),
           "block_bwd_max_err_over_bound": max(
               c[g]["max_err_over_bound"] for c in checks["bwd"] for g in c),
           "layer_ring_max_err_over_bound": max(
               c["max_err_over_bound"] for c in checks["ring"]),
           "layer_vs_sp1_max_err_over_bound": max(
               c["max_err_over_bound"] for c in checks["vs_sp1"])}
    emit(phase, **row)
    if (row["blocks_checked_fwd"], row["blocks_checked_bwd"]) != (pairs, pairs) or \
            len(checks["ring"]) != n_layers:
        raise AssertionError(f"{phase} checked {row}")
    if not all(math.isfinite(x) for x in (l4, l1, g4, g1)):
        raise AssertionError(f"{phase} not finite: {row}")
    return row


# ----- mixture of experts, LoRA, W8A8, the int8-KV gate ----------------------

MIXTRAL_LAYERS = 4  # of 32: 11.6 GB of bf16 weights, the experts 11.3 of it
# The new phases' servers beat every 4 rounds (the default is 32): a run of
# 16 requests takes fewer than 32 rounds, and stats()'s mfu is that of the
# last heartbeat interval.
HEARTBEAT_ROUNDS = 4
# The LoRA merge check over 2 layers: adapted against merged logits within
# this share of the trained adapters' own effect (adapted against base),
# and that effect at least this multiple of the noise floor.
MERGE_GAP_OF_EFFECT = 0.5
EFFECT_OVER_NOISE = 3.0


def serve_launch_row(srv, prompts, budgets, lens) -> tuple:
    """:func:`run_requests` and :func:`serve_row` of one server: the
    outputs, the row, the launches."""
    outs, wall, launches, stats = run_requests(srv, prompts, budgets)
    row = serve_row(stats, wall, budgets, lens, launches)
    row.update(mfu=stats["mfu"], device_busy_frac=stats["device_busy_frac"],
               decode_backend=stats["decode_backend"], kv_quant=stats["kv_quant"])
    return outs, row, launches


def add_launches(total: dict, more: dict) -> None:
    for k, n in more.items():
        total[k] = total.get(k, 0) + n


# The MoE layer against its token-by-token reference: each token's largest
# |error| within this share of its largest |output| (four bf16 ulps at the
# top of its range).
MOE_LAYER_TOL = 2.0 ** -5


def moe_layer_check(params, cfg, prompts, buckets, max_len: int) -> dict:
    """The MoE layer on the card against the plain ``reference_moe`` (token
    by token: no capacity, no dispatch, no combine) on one layer's real
    inputs, recorded as the model runs: the last layer's MoE input in a
    batched prefill of ``prompts`` (the longest prompt's tokens), and in
    the decode step after it (one token a lane). ``moe_ffn`` runs at a
    capacity factor of E/K, where a buffer holds every token and nothing
    drops. Both sides take the same routing and the same bf16 products and
    part only by the rounding of differently ordered fp32 sums; a copy
    sent to a wrong slot, dropped or weighed wrongly moves its token by the
    size of its output. ``ok`` within :data:`MOE_LAYER_TOL`."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        forward,
        map_leaf,
        prefill_batch,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import moe
    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention

    lens = [len(p) for p in prompts]
    pad = next(b for b in buckets if b >= max(lens))
    toks = torch.zeros((len(prompts), pad), dtype=torch.int32, device="cuda")
    for i, p in enumerate(prompts):
        toks[i, :lens[i]] = torch.from_numpy(np.asarray(p, np.int32))
    seen, real = [], moe.moe_ffn

    def recording(p, x, c):
        seen.append(x.detach().clone())
        return real(p, x, c)

    moe.moe_ffn = recording  # the layer imports it at each call
    try:
        caches, logits, pos = prefill_batch(
            params, toks, cfg, max_len, torch.tensor(lens, dtype=torch.int32),
            kv_quantized=True)
        first = torch.argmax(logits, -1).to(torch.int32)
        forward(params, first[:, None], cfg, attn_fn=reference_attention,
                positions=pos[:, None], kv_caches=caches, cache_offset=pos)
    finally:
        moe.moe_ffn = real
    L = cfg.n_layers
    if len(seen) != 2 * L:
        raise AssertionError(f"moe_layer: {len(seen)} MoE calls, want {2 * L}")
    last = L - 1
    layer = params["layers"]
    mp = {"router": layer["router"][last]}
    mp.update({k: map_leaf(lambda t: t[last], layer[f"moe_{k}"])
               for k in ("w_gate", "w_in", "w_out")})
    mcfg = replace(cfg.moe_cfg(),
                   capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    longest = int(np.argmax(lens))
    row = {"layer": last, "capacity_factor": mcfg.capacity_factor,
           "tol_x_token_max": MOE_LAYER_TOL}
    for what, x in (("prefill", seen[last][longest, :lens[longest]]),
                    ("decode", seen[L + last].reshape(-1, cfg.d_model))):
        got, _ = moe.moe_ffn(mp, x, mcfg)
        want = moe.reference_moe(mp, x, mcfg).float()
        err = (got.float() - want).abs().amax(-1)
        top = want.abs().amax(-1).clamp_min(2.0 ** -30)
        row[what] = {"tokens": x.shape[0], "max_abs_err": float(err.max()),
                     "max_err_over_token_max": float((err / top).max())}
    row["ok"] = all(row[w]["max_err_over_token_max"] <= MOE_LAYER_TOL
                    for w in ("prefill", "decode"))
    return row


def phase_moe(seed: int = 0, profile: bool = False) -> dict:
    """Configuration 14 (PERF.md): Mixtral-8x7B at its published widths with
    4 of its 32 layers, random bf16 weights from ``seed``, served by the
    default paged server (overlapped, graphed, int8 KV, 16 lanes, tile 16):
    16 requests of 64-1000 prompt tokens and 64-128 new ones, with bf16
    experts, then the same with int8 weights (``quantize_decoder_params``:
    the attention projections and the expert stacks, per-expert scales).
    Each run asserts the flash and paged launches as the serve phase counts
    them and ``0 < mfu <= 1``; ``graph_check`` (a chunk's replay, MoE
    dispatch included, bit-equal to eager), a ``crosscheck`` (every
    layer's kernel call against the plain version, logits within the
    serving bound or twice the noise floor; both paths run the same MoE
    layer, and routing flips put the noise floor past the logit RMS, so
    this holds the attention kernels alone) and :func:`moe_layer_check`
    (the MoE layer against ``reference_moe``) on each. Printed: tok/s,
    TTFT/ITL, the ledger's ``mfu``, the token match int8 against bf16.
    ``profile`` adds a profiled window of decode rounds of each (16 lanes
    busy)."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.guest.serving import _tensor_leaves
    from kata_xpu_device_plugin_tpu_torch.models import init_params, mixtral_8x7b
    from kata_xpu_device_plugin_tpu_torch.ops.quant import quantize_decoder_params

    cfg = mixtral_8x7b(n_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    max_len = 2048
    buckets = (128, 256, 512, 1024)
    kw = dict(max_batch=16, max_len=max_len, prefill_buckets=buckets, chunk=8,
              kv_pool_tokens=16 * max_len + 32, kv_block_size=16,
              heartbeat_rounds=HEARTBEAT_ROUNDS)
    prompts, budgets, lens = phase_requests(16, cfg.vocab_size, seed)
    launches, outs, failures = {}, {}, []
    for experts in ("bf16", "int8"):
        if experts == "int8":
            params = quantize_decoder_params(params)
            torch.cuda.empty_cache()
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in _tensor_leaves(params))
        srv = GenerationServer(params, cfg, **kw)
        outs[experts], row, run = serve_launch_row(srv, prompts, budgets, lens)
        del srv
        add_launches(launches, run)
        if not 0 < row["mfu"] <= 1:
            failures.append(f"{experts}: mfu {row['mfu']}")
        gc_row = graph_check(params, cfg, kw, seed=seed)
        cc = crosscheck(params, cfg, prompts[int(lens.argmax())], buckets, max_len)
        try:
            assert_family_crosscheck(cc, cfg.n_layers)
        except AssertionError as e:
            failures.append(f"{experts}: {e}")
        layer_row = moe_layer_check(params, cfg, prompts, buckets, max_len)
        if not layer_row["ok"]:
            failures.append(f"{experts}: MoE layer against reference_moe {layer_row}")
        emit("moe", model="mixtral_8x7b", experts=experts,
             reduced=f"n_layers={MIXTRAL_LAYERS} of {mixtral_8x7b().n_layers}",
             num_experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
             capacity_factor=cfg.moe_capacity_factor, config=dict(kw),
             weight_bytes=weight_bytes, init_s=round(init_s, 3),
             prompt_lens=lens.tolist(), **row,
             graph_check=gc_row["outputs_bit_equal"] and gc_row["arena_bit_equal"],
             crosscheck={k: v for k, v in cc.items() if k != "logit_bound_x_rms"},
             moe_layer=layer_row,
             token_match_vs_bf16=(token_match(outs["int8"], outs["bf16"], budgets)
                                  if experts == "int8" else None))
        if profile:
            profile_rounds(params, cfg, kw, np.random.default_rng(seed), lanes=16,
                           model=f"mixtral_8x7b, {experts} experts")
    del params
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("moe: " + "; ".join(failures))
    return launches


def first_logits(params, cfg, prompt, buckets, max_len: int, attn_fn=None):
    """The served prefill's first-token logits of one request (the flash
    path unless ``attn_fn`` is given, an int8 cache), ``[1, vocab]`` fp32."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import prefill_batch

    n = len(prompt)
    pad = next(b for b in buckets if b >= n)
    toks = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    toks[0, :n] = torch.from_numpy(np.asarray(prompt, np.int32))
    _, logits, _ = prefill_batch(params, toks, cfg, max_len,
                                 torch.tensor([n], dtype=torch.int32),
                                 attn_fn=attn_fn, kv_quantized=True)
    return logits


def first_layers(params, n: int):
    """The params of a model's first ``n`` layers (views, no copy)."""
    from kata_xpu_device_plugin_tpu_torch.models.transformer import map_leaf

    out = dict(params)
    out["layers"] = {k: map_leaf(lambda t: t[:n], v)
                     for k, v in params["layers"].items()}
    return out


def phase_lora(seed: int = 0) -> dict:
    """Configuration 15 (PERF.md): Gemma-2B at full width, random bf16
    weights (the training layout: separate wq/wk/wv), ``apply_lora`` rank 8
    on the default targets (wq, wk, wv, wo). A fresh adapter's server must
    give the base server's tokens bit for bit (16 requests, the serve
    phase's). Then 4 ``make_lora_train_step`` steps (lr 1e-3) at B=1,
    S=1024 on one batch: the loss falls, the bases and the embedding keep
    their bytes, each flash kernel launches steps x layers times. Then the
    trained adapters served beside ``merge_lora`` of them (bf16 weights,
    the token match printed), and first-token logits of four requests,
    adapted against merged: asserted within the serving bound over the
    first 2 layers and within half the adapters' effect there (adapted
    against base), an effect that must be 3x the noise floor (flash
    against ``plain_fp32_p`` attention, adapted); printed over all 18
    beside that noise floor (the merge's bf16 rounding of every weight,
    0.2%, is a perturbation that 18 random layers carry to the logit RMS,
    as they carry a different bf16 attention to half of it; PERF.md).
    Then QLoRA: the int8 fused base with fresh adapters on ("wqkv", "wo")
    served (tokens equal to the int8 base server's) and its
    ``graph_check``."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models import (
        fuse_decoder_params,
        gemma_2b,
        init_params,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import flash
    from kata_xpu_device_plugin_tpu_torch.ops.lora import (
        apply_lora,
        make_lora_train_step,
        merge_lora,
    )
    from kata_xpu_device_plugin_tpu_torch.ops.quant import quantize_decoder_params

    cfg = gemma_2b()
    base = init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    adapted = apply_lora(base, gen, rank=8)
    kw = dict(SERVE_KW, **PAGED_KW, heartbeat_rounds=HEARTBEAT_ROUNDS)
    prompts, budgets, lens = phase_requests(16, cfg.vocab_size, seed, skip=100)
    launches, failures, rows = {}, [], {}
    served = {}
    for name, tree in (("base", base), ("fresh_lora", adapted)):
        served[name], rows[name], run = serve_launch_row(
            GenerationServer(tree, cfg, **kw), prompts, budgets, lens)
        add_launches(launches, run)
    fresh = token_match(served["fresh_lora"], served["base"], budgets)
    if fresh["requests_identical"] != len(budgets):
        failures.append(f"fresh adapters changed the base model's tokens {fresh}")

    # Fine-tuning: only the adapters move.
    targets = ("wq", "wk", "wv", "wo")
    kept = {k: _bits(adapted["layers"][k].base).clone() for k in targets}
    embed_bits = _bits(base["embed"]).clone()
    init_state, step = make_lora_train_step(cfg, lr=1e-3)
    state = init_state(adapted)
    batch = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, 1024))
    kernels = (flash.flash_forward, flash.flash_bwd_dq, flash.flash_bwd_dkv)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, stamps = [], []
    for _ in range(4):
        state, loss = step(state, batch)
        losses.append(float(loss))
        stamps.append(time.perf_counter())
    train_launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                              (fn.launches for fn in kernels)))
    add_launches(launches, train_launches)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        failures.append(f"LoRA loss not finite and falling: {losses}")
    want = 4 * cfg.n_layers
    if any(n != want for n in train_launches.values()):
        failures.append(f"LoRA train launches {train_launches}, want {want} each")
    trained = state["params"]
    base_kept = all(torch.equal(_bits(trained["layers"][k].base), kept[k])
                    for k in targets) and torch.equal(_bits(trained["embed"]),
                                                      embed_bits)
    if not base_kept:
        failures.append("a LoRA step changed a frozen weight")

    # Trained adapters against their merge.
    merged = merge_lora(trained)
    for name, tree in (("trained_lora", trained), ("merged", merged)):
        served[name], rows[name], run = serve_launch_row(
            GenerationServer(tree, cfg, **kw), prompts, budgets, lens)
        add_launches(launches, run)
    merge_rows = []
    shallow = replace(cfg, n_layers=2)
    bk = (SERVE_KW["prefill_buckets"], SERVE_KW["max_len"])
    for i in range(4):
        la = first_logits(trained, cfg, prompts[i], *bk)
        lm = first_logits(merged, cfg, prompts[i], *bk)
        ln = first_logits(trained, cfg, prompts[i], *bk, attn_fn=plain_fp32_p)
        la2 = first_logits(first_layers(trained, 2), shallow, prompts[i], *bk)
        lm2 = first_logits(first_layers(merged, 2), shallow, prompts[i], *bk)
        lb2 = first_logits(first_layers(base, 2), shallow, prompts[i], *bk)
        ln2 = first_logits(first_layers(trained, 2), shallow, prompts[i], *bk,
                           attn_fn=plain_fp32_p)
        rms2 = float(lm2.square().mean().sqrt())
        row = {"logit_err_2": float((la2 - lm2).abs().max()), "logit_rms_2": rms2,
               "adapter_effect_2": float((la2 - lb2).abs().max()),
               "noise_err_2": float((ln2 - la2).abs().max()),
               "logit_err": float((la - lm).abs().max()),
               "logit_rms": float(lm.square().mean().sqrt()),
               "noise_err": float((ln - la).abs().max())}
        merge_rows.append(row)
        # The merge must carry the adapters' effect: the adapted-merged gap
        # is held to a share of that effect, and the effect must stand
        # clear of the noise, so a dropped delta on either side fails.
        if not (row["logit_err_2"] <= LOGIT_BOUND["prefill"] * rms2
                and row["logit_err_2"] <= MERGE_GAP_OF_EFFECT * row["adapter_effect_2"]
                and row["adapter_effect_2"] >= EFFECT_OVER_NOISE * row["noise_err_2"]):
            failures.append(f"adapted vs merged logits at 2 layers {row}")
    del merged, trained, state, adapted
    torch.cuda.empty_cache()

    # QLoRA: the int8 fused base with adapters on the fused projections.
    qbase = quantize_decoder_params(fuse_decoder_params(base))
    del base
    torch.cuda.empty_cache()
    qlora = apply_lora(qbase, gen, rank=8, targets=("wqkv", "wo"))
    for name, tree in (("int8_base", qbase), ("qlora", qlora)):
        served[name], rows[name], run = serve_launch_row(
            GenerationServer(tree, cfg, **kw), prompts, budgets, lens)
        add_launches(launches, run)
    q_fresh = token_match(served["qlora"], served["int8_base"], budgets)
    if q_fresh["requests_identical"] != len(budgets):
        failures.append(f"fresh QLoRA adapters changed the int8 model {q_fresh}")
    gc_row = graph_check(qlora, cfg, kw, seed=seed)
    emit("lora", model="gemma_2b", rank=8, alpha=16.0, targets=list(targets),
         config=dict(kw), servers={k: {f: r[f] for f in SIDE_KEYS + ("mfu",)}
                                   for k, r in rows.items()},
         fresh_vs_base=fresh,
         train=dict(B=1, S=1024, lr=1e-3, losses=losses,
                    step_s=[b - a for a, b in zip([t0] + stamps, stamps)],
                    launches=train_launches, base_bytes_unchanged=base_kept),
         trained_vs_merged=dict(tokens=token_match(served["trained_lora"],
                                                   served["merged"], budgets),
                                first_logits=merge_rows),
         qlora_targets=["wqkv", "wo"], qlora_fresh_vs_int8=q_fresh,
         qlora_graph_check=gc_row["outputs_bit_equal"] and gc_row["arena_bit_equal"])
    del qlora, qbase
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("lora: " + "; ".join(failures))
    return launches


def phase_w8a8(params, cfg, seed: int = 0) -> dict:
    """Configuration 16 (PERF.md): Gemma-2B int8 (fused, then quantized)
    served by the default paged server with W8A8 off, then on
    (``set_w8a8``, before the server is built: a graph keeps the mode it
    was captured under), the serve phase's 16 requests: tok/s, TTFT/ITL,
    the token match. Then JAX's op bound (``|out - ref| <= 0.05 x max|ref|
    + 1e-3``, W8A8 against weight-only) at the ``wqkv`` and ``w_down``
    shapes, 8 and 16 rows, through ``torch._int_mm`` (rows padded)."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.ops import quant

    qparams = quant.quantize_decoder_params(params)
    kw = dict(SERVE_KW, **PAGED_KW, heartbeat_rounds=HEARTBEAT_ROUNDS)
    prompts, budgets, lens = phase_requests(16, cfg.vocab_size, seed, skip=100)
    launches, rows, outs, bounds, failures = {}, {}, {}, [], []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    try:
        for mode in ("weight_only", "w8a8"):
            quant.set_w8a8(mode == "w8a8")
            outs[mode], rows[mode], run = serve_launch_row(
                GenerationServer(qparams, cfg, **kw), prompts, budgets, lens)
            add_launches(launches, run)
        for name in ("wqkv", "w_down"):
            w = qparams["layers"][name]
            w = quant.QTensor(w.q[0], w.scale[0])
            for rows_n in (8, 16):
                x = torch.randn((rows_n, w.q.shape[0]), generator=gen,
                                device="cuda").to(torch.bfloat16)
                quant.set_w8a8(False)
                ref = quant.weight_matmul(x, w).float()
                quant.set_w8a8(True)
                out = quant.weight_matmul(x, w).float()
                err = float((out - ref).abs().max())
                bound = 0.05 * float(ref.abs().max()) + 1e-3
                bounds.append(dict(weight=name, shape=list(w.q.shape), rows=rows_n,
                                   max_abs_err=err, bound=bound))
                if not err <= bound:
                    failures.append(f"W8A8 {name} at {rows_n} rows: {err} > {bound}")
        timings = w8a8_op_timings(qparams, gen)
    finally:
        quant.set_w8a8(False)
    emit("w8a8", model="gemma_2b", weights="int8 fused", config=dict(kw),
         servers={m: {f: r[f] for f in SIDE_KEYS + ("mfu",)}
                  for m, r in rows.items()},
         token_match=token_match(outs["w8a8"], outs["weight_only"], budgets),
         op_bound=bounds, op_ms=timings,
         tok_s_ratio=rows["w8a8"]["tok_s"] / rows["weight_only"]["tok_s"])
    del qparams
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("w8a8: " + "; ".join(failures))
    return launches


def w8a8_op_timings(qparams, gen) -> list:
    """Where a W8A8 matmul's time goes at a decode shape (16 rows) and a
    prefill one (1024), Gemma-2B's ``wqkv`` and ``w_down``, each by CUDA
    graph replay: the weight-only int8 matmul, the W8A8 one, its
    ``torch._int_mm`` alone on a row-major weight (the layout the port
    keeps) and on a column-major copy, and a bf16 ``mm`` on a bf16 copy."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops import quant

    out = []
    for name in ("wqkv", "w_down"):
        w = qparams["layers"][name]
        w = quant.QTensor(w.q[0], w.scale[0])
        col = w.q.t().contiguous().t()
        wb = quant.dequantize(w, torch.bfloat16)
        for rows_n in (16, 1024):
            x = torch.randn((rows_n, w.q.shape[0]), generator=gen,
                            device="cuda").to(torch.bfloat16)
            xq = quant.quantize(x, dim=-1).q
            xp = torch.cat([xq, xq.new_zeros((max(0, 32 - rows_n), xq.shape[1]))])
            row = dict(weight=name, shape=list(w.q.shape), rows=rows_n)
            quant.set_w8a8(False)
            row["weight_only_ms"] = graph_ms(lambda: quant.weight_matmul(x, w), 20)
            quant.set_w8a8(True)
            row["w8a8_ms"] = graph_ms(lambda: quant.weight_matmul(x, w), 20)
            row["int_mm_row_major_ms"] = graph_ms(lambda: torch._int_mm(xp, w.q), 20)
            row["int_mm_col_major_ms"] = graph_ms(lambda: torch._int_mm(xp, col), 20)
            row["bf16_mm_ms"] = graph_ms(lambda: x @ wb, 20)
            out.append(row)
    return out


def phase_kv_gate(params, cfg, seed: int = 0) -> dict:
    """The int8-KV gate's evidence (``scripts/torch_eval_kv_quant.py``) at
    Gemma-2B's width on the random weights: four prompts of 128-512
    tokens, 12 greedy steps over an int8 and a bf16 cache through the
    flash and paged decode kernels. The thresholds (0.7 agreement, 0.5
    logit drift) were set on the JAX package's tiny test model, not for
    this model on random weights: the verdict is printed, not asserted;
    the evidence must be finite and in range."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import CUDA_PAD
    from kata_xpu_device_plugin_tpu_torch.ops import attention, decode_attn, flash

    gate_mod = load_script("torch_eval_kv_quant")
    lengths = [CUDA_PAD * (i + 1) for i in range(4)]
    steps = 12
    max_len = -(-(lengths[-1] + steps) // CUDA_PAD) * CUDA_PAD
    kernel_fn = attention.make_decode_attn_fn(cfg, arena_len=max_len, device="cuda")
    prompts = gate_mod.default_prompts(cfg.vocab_size, 4, seed, lengths)
    kernels = {"flash_fwd": flash.flash_forward,
               "paged_decode": decode_attn.paged_decode_attention}
    for fn in kernels.values():
        fn.launches = 0
    result = gate_mod.evaluate_kv_quant(params, cfg, prompts, steps=steps,
                                        max_len=max_len, decode_kernel_fn=kernel_fn)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    verdict = gate_mod.gate(result)
    emit("kv_gate", model="gemma_2b", weights="random bf16",
         thresholds=dict(min_greedy_match=gate_mod.DEFAULT_MIN_GREEDY_MATCH,
                         max_logit_err=gate_mod.DEFAULT_MAX_LOGIT_ERR),
         gate="pass" if verdict else "fail", asserted=False, launches=launches,
         **{k: v for k, v in result.items()})
    # 2 prefills and 2 x (1 + steps) decode steps a prompt, every layer.
    want = {"flash_fwd": 2 * 4 * cfg.n_layers,
            "paged_decode": 2 * 4 * (1 + steps) * cfg.n_layers}
    if (launches != want or not 0.0 <= result["greedy_match"] <= 1.0
            or not math.isfinite(result["logit_max_abs_err"])):
        raise AssertionError(f"kv_gate evidence {result}, launches {launches}, "
                             f"want {want}")
    return launches


# ----- training at scale: FSDP x TP, the pipeline, expert parallelism, LoRA ----

BF16_U = 2.0 ** -8  # bf16's unit roundoff: half an ulp, relative
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BLOCK_KERNELS = ("flash_fwd_block", "flash_bwd_dq_block", "flash_bwd_dkv_block")


def kernel_counters() -> dict:
    """The six flash wrappers' launch counters by kernel name."""
    from kata_xpu_device_plugin_tpu_torch.ops import flash

    return {"flash_fwd": flash.flash_forward, "flash_bwd_dq": flash.flash_bwd_dq,
            "flash_bwd_dkv": flash.flash_bwd_dkv,
            "flash_fwd_block": flash.flash_block_forward,
            "flash_bwd_dq_block": flash.flash_block_bwd_dq,
            "flash_bwd_dkv_block": flash.flash_block_bwd_dkv}


def reset_counts() -> None:
    from kata_xpu_device_plugin_tpu_torch.ops import flash

    for fn in kernel_counters().values():
        fn.launches = 0
    flash._kernel_operand.copies = 0


def set_counts(counts: dict) -> None:
    """The counters as :func:`read_counts` read them."""
    from kata_xpu_device_plugin_tpu_torch.ops import flash

    for name, fn in kernel_counters().items():
        fn.launches = counts[name]
    flash._kernel_operand.copies = counts["operand_copies"]


def read_counts() -> dict:
    from kata_xpu_device_plugin_tpu_torch.ops import flash

    out = {name: fn.launches for name, fn in kernel_counters().items()}
    out["operand_copies"] = flash._kernel_operand.copies
    return out


def expect_counts(phase: str, counts: dict, want: dict) -> None:
    """Every flash counter at exactly its expected count (0 where not
    named), and no operand copied for a launch."""
    full = {name: want.get(name, 0) for name in kernel_counters()}
    full["operand_copies"] = 0
    if counts != full:
        raise AssertionError(f"{phase} launches {counts}, want {full}")


def _base_weight(w):
    """The float weight a site's partial products use: a LoRA adapter's
    base (its delta is zero in the first step), a tensor itself."""
    from kata_xpu_device_plugin_tpu_torch.ops.lora import LoRAWeight

    if isinstance(w, LoRAWeight):
        w = w.base
    if isinstance(w, tuple):
        raise TypeError("the rounding bound takes float weights")
    return w


def rounding_bound(params, tokens, cfg, tp: int) -> dict:
    """How far the sharded step's first loss may lie from the unsharded
    step's, from the same fp32 weights and tokens: the probabilistic
    rounding-error model (each bf16 rounding an independent error of at
    most u = 2^-8 of the value it rounds, zero mean: Higham and Mary, SIAM
    J. Sci. Comput. 41(5), 2019), taken to first order through the
    unsharded forward (through the kernels) and its backward.

    The two programs differ only in where bf16 roundings fall; the fsdp
    gathers, the vocab-parallel lookup and the batch and head cut of the
    attention (the forward kernel computes each (row, head) alone, its
    tiles fixed by the head width) change no value. At a linear site ``y =
    x @ w`` (every projection, an MoE expert's products) the sharded side
    may round the ``tp`` partial products ``P_m`` (the contraction cut in
    ``tp``) and their sum, the unsharded side rounds ``y`` once, a GEMM
    over another number of rows may accumulate in another order, and an
    elementwise op reading ``y`` may round a perturbed input the other
    way: per element a difference of variance at most ``u^2 (sum_m P_m^2
    + 4 y^2) / 3``. Summed over the sites with the backward's ``dL/dy``,
    ``sigma^2 = sum g^2 var``, and the bound is ``6 sigma`` plus 2^-20 of
    the loss for the fp32 softmax of the vocab-parallel loss (its sums
    reordered). Returns the unsharded loss, sigma, the bound and the
    forward's per-token nll (for the routing term of an MoE model)."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models import transformer as tfm
    from kata_xpu_device_plugin_tpu_torch.ops import moe as moe_mod

    sums = []
    real_wm, real_ee = tfm.weight_matmul, moe_mod._expert_einsum

    def site(y, x, w, mm):
        if not y.requires_grad:
            return y
        with torch.no_grad():
            w = _base_weight(w)
            var = 4.0 * y.float().square()
            for xm, wm_ in zip(x.tensor_split(tp, dim=-1),
                               w.tensor_split(tp, dim=-2)):
                var += mm(xm, wm_).float().square()
            var = (var * (BF16_U ** 2 / 3.0)).to(torch.bfloat16)
        y.register_hook(lambda g: sums.append(
            (g.float().square() * var.float()).sum()))
        return y

    def wm(x, w):
        return site(real_wm(x, w), x, w, real_wm)

    def ee(x, w):
        return site(real_ee(x, w), x, w, real_ee)

    emb = params["embed"].detach().requires_grad_()
    view = {**params, "embed": emb}
    tfm.weight_matmul, moe_mod._expert_einsum = wm, ee
    try:
        with torch.enable_grad():
            logits, aux = tfm.forward(view, tokens, cfg, return_aux=True)
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
            del logits, logp
            loss = nll.mean()
            if cfg.moe:
                loss = loss + cfg.moe_aux_weight * aux
            torch.autograd.grad(loss, [emb])
    finally:
        tfm.weight_matmul, moe_mod._expert_einsum = real_wm, real_ee
    # The variances were stored in bf16: 1.01 covers their rounding.
    sigma = math.sqrt(1.01 * float(torch.stack(sums).sum()))
    lv = float(loss.detach())
    return {"loss": lv, "sites": len(sums), "sigma": sigma,
            "bound": 6.0 * sigma + 2.0 ** -20 * abs(lv), "nll": nll.detach()}


def held_to(phase: str, name: str, got: float, bound: dict) -> dict:
    """``got`` against the unsharded loss within ``bound``."""
    diff = got - bound["loss"]
    row = {f"{name}_loss": got, "unsharded_loss": bound["loss"],
           f"{name}_diff": diff, "bound": bound["bound"],
           "diff_over_bound": abs(diff) / bound["bound"]}
    if not (math.isfinite(got) and abs(diff) <= bound["bound"]):
        raise AssertionError(f"{phase}: {name} loss {got} against the "
                             f"unsharded {bound['loss']}, bound {bound['bound']}")
    return row


def batch_tokens(cfg, B: int, S: int, seed: int):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def step_timer():
    """``(on_step, stamps)`` for ``fit``: each step's end, synchronized."""
    import torch

    stamps = []

    def on_step(_s, _loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    return on_step, stamps


def train_mfu(cfg, B: int, S: int, step_s: float) -> tuple:
    """The device ledger's matmul parameters (``obs.devledger.
    matmul_params``: the model counted once, whatever its cut) in the
    bench convention ``6 P tokens`` plus causal attention, over the step's
    seconds and the bf16 peak: ``(flops, mfu)``."""
    from kata_xpu_device_plugin_tpu_torch.obs import devledger

    flops = (6.0 * devledger.matmul_params(cfg) * B * S
             + 6 * cfg.n_layers * B * S * S * cfg.n_heads * cfg.head_dim)
    return flops, flops / step_s / PEAK_BF16_FLOPS


def phase_fsdp_tp(n_layers: int = 4, seed: int = 0, seq_layers: int = 8,
                  profile: bool = False) -> dict:
    """Configuration 17 (PERF.md): Llama-3-8B at its published widths, 4 of
    32 layers (8 before the guards phase joined; the checkpoint's write was
    most of the phase), ``make_train_step(cfg, mesh=build_mesh({"data": 1, "fsdp":
    2, "model": 2}))`` on one batch of B=2 windows of 2048 tokens (seen
    every step), driven by ``fit`` with a ``TrainCheckpointer`` every 2
    steps: a run of 3 steps (its checkpoint at step 2), then ``fit`` to
    step 4 over the same directory, which resumes from step 2: its step 3
    must give the first run's step-3 loss bit for bit. One checkpoint (16.8
    GB at 4 layers) is written: the card's machine takes 45 GiB of writes a
    call.
    First the unsharded forward from the same weights (the loss of the
    unsharded step's first step) and :func:`rounding_bound`; the sharded
    first loss within it. Launch counts reset just before the runs and
    read just after: each kernel layers x 4 local blocks a step, no
    operand copied. Then one step over ``{"fsdp": 2, "model": 2, "seq":
    2}`` at S=4096 (the ring per batch and head shard through K1), its
    loss within its own bound of the unsharded loss. ``profile`` adds a
    profiled fifth step."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.models import init_params
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        TokenBatchLoader,
        build_mesh,
        fit,
        make_optimizer,
        make_train_step,
    )

    cfg = models.llama3_8b(n_layers=n_layers)
    B, S = 2, 2048
    shape = {"data": 1, "fsdp": 2, "model": 2}
    toks = batch_tokens(cfg, B, S, seed)
    whole = init_params(cfg, seed=seed, device="cuda", dtype=torch.float32)
    reset_counts()
    bound = rounding_bound(whole, torch.from_numpy(toks).cuda(), cfg,
                           tp=shape["model"])
    unsharded_counts = read_counts()
    del whole
    torch.cuda.empty_cache()

    init_state, step = make_train_step(cfg, make_optimizer(),
                                       mesh=build_mesh(shape))
    ckpt_dir = tempfile.mkdtemp(prefix="fsdp_tp_ckpt_")
    free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
    runs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        for name, steps, every in (("first", 3, 2), ("resumed", 4, 0)):
            loader = TokenBatchLoader(toks.reshape(-1), batch=B, seq_len=S - 1,
                                      shuffle=False)
            on_step, stamps = step_timer()
            t0 = time.perf_counter()
            state, losses = fit(init_state, step, loader, steps=steps,
                                seed=seed, ckpt_dir=ckpt_dir, ckpt_every=every,
                                on_step=on_step)
            runs[name] = {"losses": losses, "t0": t0, "stamps": stamps}
            if profile and name == "resumed":
                # Profiled outside the counted runs: the counts as they were.
                counts_before = read_counts()
                profiled(f"llama3_8b fsdp2 x model2 step 5, B={B}, S={S}",
                         lambda: step(state, toks))
                set_counts(counts_before)
            del state
            torch.cuda.empty_cache()
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, n))
                         for n in os.listdir(ckpt_dir))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    first, resumed = runs["first"], runs["resumed"]
    losses = first["losses"] + resumed["losses"][1:]
    # Step 3 of the first run follows step 2's checkpoint write: its span
    # is the write and a step.
    spans = [b - a for a, b in zip(first["stamps"], first["stamps"][1:])]
    step_s = ([spans[0]]
              + [b - a for a, b in zip(resumed["stamps"], resumed["stamps"][1:])])
    p50 = float(np.median(step_s))
    flops, mfu = train_mfu(cfg, B, S, p50)
    per_step = n_layers * 4
    n_steps = 3 + 2
    row = {"model": "llama3_8b", "n_layers": n_layers,
           "reduced": f"n_layers={n_layers} (from 32; one card's memory and "
                      "the run's time)",
           "mesh": shape, "B": B, "S": S, "losses": losses,
           **held_to("fsdp_tp", "sharded_first", losses[0], bound),
           "bound_sites": bound["sites"], "sigma": bound["sigma"],
           "first_step_s": first["stamps"][0] - first["t0"],
           "resume_first_step_s": resumed["stamps"][0] - resumed["t0"],
           "step_s": step_s, "step_p50_s": p50, "tokens_per_s": B * S / p50,
           "model_flops_per_step": flops, "mfu": mfu, "peak_mem_bytes": peak,
           "checkpoint_bytes": ckpt_bytes, "disk_free_gb": free_gb,
           "checkpoint_write_and_step_s": spans[1],
           "step3_loss": first["losses"][2],
           "resumed_step3_loss": resumed["losses"][0],
           "resume_bit_equal": resumed["losses"][0] == first["losses"][2],
           "launches": counts, "steps_launched": n_steps,
           "launches_per_step": per_step, "unsharded_launches": unsharded_counts}
    emit("fsdp_tp", **row)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"fsdp_tp loss not finite and falling: {losses}")
    if not row["resume_bit_equal"]:
        raise AssertionError(f"fsdp_tp resume: {resumed['losses'][0]!r} != "
                             f"{first['losses'][2]!r}")
    expect_counts("fsdp_tp", counts, {k: n_steps * per_step for k in FLASH_KERNELS})
    expect_counts("fsdp_tp unsharded", unsharded_counts,
                  {k: n_layers for k in FLASH_KERNELS})
    out = {k: counts[k] for k in FLASH_KERNELS}

    # seq x fsdp x model at S=4096: the ring per (batch, head) shard.
    cfg_s = models.llama3_8b(n_layers=seq_layers)
    S2 = 4096
    toks2 = torch.from_numpy(batch_tokens(cfg_s, B, S2, seed + 1)).cuda()
    whole = init_params(cfg_s, seed=seed, device="cuda", dtype=torch.float32)
    bound2 = rounding_bound(whole, toks2, cfg_s, tp=2)
    del whole
    torch.cuda.empty_cache()
    mesh2 = build_mesh({"fsdp": 2, "model": 2, "seq": 2})
    init2, step2 = make_train_step(cfg_s, make_optimizer(), mesh=mesh2)
    state = init2(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t2 = time.perf_counter()
    state, loss2 = step2(state, toks2)
    loss2 = float(loss2)
    seq_s = time.perf_counter() - t2
    counts2 = read_counts()
    peak2 = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    rings, pairs = 2 * 2, 3  # (batch, head) shards; live pairs of a ring of 2
    want2 = seq_layers * rings * pairs
    emit("fsdp_tp_seq", model="llama3_8b", n_layers=seq_layers,
         mesh={"fsdp": 2, "model": 2, "seq": 2}, B=B, S=S2, S_loc=S2 // 2,
         **held_to("fsdp_tp_seq", "sharded", loss2, bound2),
         bound_sites=bound2["sites"], step_s=seq_s, peak_mem_bytes=peak2,
         launches=counts2, launches_per_step=want2)
    expect_counts("fsdp_tp_seq", counts2, {k: want2 for k in BLOCK_KERNELS})
    for k in BLOCK_KERNELS:
        out[k] = counts2[k]
    return out


def phase_pipeline(n_layers: int = 4, steps: int = 3, seed: int = 0) -> dict:
    """Configuration 18 (PERF.md): Llama-3-8B at its published widths, 4 of
    32 layers, ``make_pp_train_step`` on ``composed_mesh(2, 2, 2)`` with
    M=4 microbatches of mb=2 windows of 2048 tokens (one batch, seen every
    step), then the flat step over ``{"data": 1, "fsdp": 4, "model": 2}``
    from the same weights on the same 8 windows (JAX's
    ``tests/test_composed.py`` pairing). The first losses within
    :func:`rounding_bound` (tp=2 on both sides) of the unsharded loss, the
    later ones printed beside each other; launches: the composed step M x
    layers x 4 local blocks a kernel a step, the flat one layers x 8."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.models import init_params
    from kata_xpu_device_plugin_tpu_torch.obs import devledger
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        build_mesh,
        composed_mesh,
        make_optimizer,
        make_pp_train_step,
        make_train_step,
    )
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves, local

    cfg = models.llama3_8b(n_layers=n_layers)
    M, mb, S = 4, 2, 2048
    toks = torch.from_numpy(batch_tokens(cfg, M * mb, S, seed)).cuda()
    params = init_params(cfg, seed=seed, device="cuda", dtype=torch.float32)
    bound = rounding_bound(params, toks, cfg, tp=2)
    del params
    torch.cuda.empty_cache()
    rows = {}
    for name in ("composed", "flat"):
        if name == "composed":
            init_state, step = make_pp_train_step(
                cfg, composed_mesh(2, 2, 2), 2, M, make_optimizer())
            batch = toks.reshape(M, mb, S)
            want = M * n_layers * 4
        else:
            init_state, step = make_train_step(
                cfg, make_optimizer(),
                mesh=build_mesh({"data": 1, "fsdp": 4, "model": 2}))
            batch = toks
            want = n_layers * 8
        state = init_state(seed)
        if name == "composed":  # the ledger counts the model once
            mm = sum(local(state["params"]["layers"][k]).numel()
                     for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
            mm += local(state["params"]["unembed"]).numel()
            if mm != devledger.matmul_params(cfg):
                raise AssertionError(f"pipeline: matmul params {mm} != ledger's "
                                     f"{devledger.matmul_params(cfg)}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, stamps = [], [time.perf_counter()]
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(float(loss))
            stamps.append(time.perf_counter())
        counts = read_counts()
        n_params = sum(t.numel() for t in leaves(state["params"]))
        rows[name] = {"losses": losses,
                      "step_s": [b - a for a, b in zip(stamps, stamps[1:])],
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "params": n_params, "launches": counts,
                      "launches_per_step": want}
        del state
        torch.cuda.empty_cache()
        expect_counts(f"pipeline {name}", counts,
                      {k: steps * want for k in FLASH_KERNELS})
        held_to(f"pipeline {name}", name, losses[0], bound)
    comp, flat = rows["composed"], rows["flat"]
    p50 = float(np.median(comp["step_s"][1:]))
    flops, mfu = train_mfu(cfg, M * mb, S, p50)
    emit("pipeline", model="llama3_8b", n_layers=n_layers,
         reduced=f"n_layers={n_layers} (from 32; the phase's memory and time)",
         mesh={"pipe": 2, "fsdp": 2, "model": 2}, M=M, mb=mb, S=S, steps=steps,
         flat_mesh={"data": 1, "fsdp": 4, "model": 2},
         unsharded_loss=bound["loss"], bound=bound["bound"],
         loss_diffs=[a - b for a, b in zip(comp["losses"], flat["losses"])],
         step_p50_s=p50, tokens_per_s=M * mb * S / p50,
         model_flops_per_step=flops, mfu=mfu, composed=comp, flat=flat)
    for r in rows.values():
        if not all(math.isfinite(x) for x in r["losses"]) or \
                not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"pipeline loss not finite and falling: {rows}")
    return {k: comp["launches"][k] + flat["launches"][k] for k in FLASH_KERNELS}


def _sharded_top_e(records: list, mesh, B: int, S: int, K: int):
    """The routed experts ``[B·S, K]`` of one ``moe_ffn_sharded`` call,
    from its shards' ``_route`` records in grid order, placed back by the
    dispatch's own token cut."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.ops import moe as moe_mod

    ea = moe_mod.expert_axis_for(mesh)
    names = tuple(mesh.axis_names)
    all_axes = tuple(a for a in names if a != ea) + (ea,)
    b_axes, s_axes = moe_mod._assign_token_axes((B, S), all_axes, mesh, ea)
    out = torch.empty((B, S, K), dtype=torch.int64, device=records[0].device)
    for rec, c in zip(records, moe_mod._product([mesh.shape[a] for a in names])):
        coords = dict(zip(names, c))
        bi, nb = moe_mod._radix(coords, b_axes, mesh)
        si, ns = moe_mod._radix(coords, s_axes, mesh)
        out[bi * B // nb:(bi + 1) * B // nb,
            si * S // ns:(si + 1) * S // ns] = rec.reshape(B // nb, S // ns, K)
    return out.reshape(B * S, K)


def phase_ep_moe(steps: int = 2, seed: int = 0) -> dict:
    """Configuration 19 (PERF.md): Mixtral-8x7B at its published widths, 1
    of 32 layers (27 GB of fp32 state), B=2 windows of 1024 tokens, experts
    over the model axis of ``{"fsdp": 1, "model": 2}``
    (``moe_ffn_sharded``: 4 experts a shard, the two all-to-alls per
    layer), ``steps`` steps at a capacity factor of E/K = 4, where no copy
    can drop. The first loss within :func:`rounding_bound` (the experts'
    products are sites too) plus a routing term: a token whose top-2 set
    differs between the two sides (counted from both sides' routers) may
    move its nll by up to the larger of the two, so ``flips/N x 2 max
    nll``. Then one forward at the default factor 2: each shard's drops."""
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.models import init_params
    from kata_xpu_device_plugin_tpu_torch.ops import moe as moe_mod
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        build_mesh,
        make_optimizer,
        make_train_step,
        spmd,
    )
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves

    E, K = 8, 2
    cfg = models.mixtral_8x7b(n_layers=1, moe_capacity_factor=E / K)
    B, S = 2, 1024
    toks = torch.from_numpy(batch_tokens(cfg, B, S, seed)).cuda()
    mesh = build_mesh({"fsdp": 1, "model": 2})
    real_route, real_dispatch = moe_mod._route, moe_mod._dispatch
    routes, drops = [], []

    def route(params, tokens, c):
        gates, top_e, probs = real_route(params, tokens, c)
        routes.append(top_e.detach())
        return gates, top_e, probs

    def dispatch(tokens, top_e, gates, n_exp, cap):
        out = real_dispatch(tokens, top_e, gates, n_exp, cap)
        drops.append(int((out[3] - cap).clamp(min=0).sum()))
        return out

    params = init_params(cfg, seed=seed, device="cuda", dtype=torch.float32)
    moe_mod._route = route
    try:
        bound = rounding_bound(params, toks, cfg, tp=2)
    finally:
        moe_mod._route = real_route
    plain_top = routes[0]
    del params
    torch.cuda.empty_cache()
    init_state, step = make_train_step(cfg, make_optimizer(), mesh=mesh)
    state = init_state(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    routes.clear()
    reset_counts()
    losses, stamps = [], [time.perf_counter()]
    moe_mod._route, moe_mod._dispatch = route, dispatch
    try:
        for i in range(steps):
            state, loss = step(state, toks)
            losses.append(float(loss))
            stamps.append(time.perf_counter())
            if i == 0:
                top = _sharded_top_e(routes[:2], mesh, B, S, K)
                no_drop = list(drops)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(t.numel() for t in leaves(state["params"]))
        # One forward at the default factor: each shard's drops.
        drops.clear()
        with torch.no_grad():
            spmd.next_token_loss(state["params"], toks,
                                 models.mixtral_8x7b(n_layers=1), mesh,
                                 moe_mesh=mesh)
        default_drops = list(drops)
    finally:
        moe_mod._route, moe_mod._dispatch = real_route, real_dispatch
    del state
    torch.cuda.empty_cache()
    flips = int((plain_top.sort(dim=-1).values
                 != top.sort(dim=-1).values).any(dim=-1).sum())
    n_tok = B * (S - 1)
    route_term = flips / n_tok * 2 * float(bound["nll"].max())
    routed = {**bound, "bound": bound["bound"] + route_term}
    want = 1 * 2  # 1 layer x 2 head shards (the batch uncut)
    row = {"model": "mixtral_8x7b", "n_layers": 1,
           "reduced": "n_layers=1 (from 32; one card's memory: 27 GB of "
                      "fp32 state)", "mesh": {"fsdp": 1, "model": 2},
           "B": B, "S": S, "steps": steps, "losses": losses,
           "capacity_factor": E / K,
           **held_to("ep_moe", "sharded_first", losses[0], routed),
           "first_order_bound": bound["bound"], "routing_flips": flips,
           "routing_term": route_term, "drops_no_drop_factor": no_drop,
           "drops_default_factor_per_shard": default_drops,
           "step_s": [b - a for a, b in zip(stamps, stamps[1:])],
           "peak_mem_bytes": peak, "params": n_params, "launches": counts,
           "launches_per_step": want}
    emit("ep_moe", **row)
    if any(no_drop):
        raise AssertionError(f"ep_moe: drops at factor {E / K}: {no_drop}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ep_moe losses not finite: {losses}")
    expect_counts("ep_moe", counts, {k: steps * want for k in FLASH_KERNELS})
    return {k: counts[k] for k in FLASH_KERNELS}


def phase_lora_mesh(steps: int = 2, seed: int = 0) -> dict:
    """Configuration 20 (PERF.md): Gemma-2B at full width (18 layers),
    fp32 base, rank-8 adapters on wq/wk/wv/wo, ``make_lora_train_step``
    unsharded and over ``{"fsdp": 2, "model": 2}`` from the same adapted
    tree, ``steps`` steps each on B=2 windows of 2048 tokens. Gemma-2B's
    one KV head does not divide the model axis, so attention runs over
    all heads a batch shard (2 local blocks a layer). The first losses
    (b = 0: the base model) within :func:`rounding_bound`; the base pieces
    bit-equal to the base after the steps."""
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.models import init_params
    from kata_xpu_device_plugin_tpu_torch.ops.lora import (
        LoRAWeight,
        apply_lora,
        make_lora_train_step,
    )
    from kata_xpu_device_plugin_tpu_torch.parallel import build_mesh
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import local

    cfg = models.gemma_2b()
    B, S = 2, 2048
    toks = torch.from_numpy(batch_tokens(cfg, B, S, seed)).cuda()
    base = init_params(cfg, seed=seed, device="cuda", dtype=torch.float32)
    bound = rounding_bound(base, toks, cfg, tp=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    adapted = apply_lora(base, gen, rank=8)
    mesh = build_mesh({"fsdp": 2, "model": 2})
    rows = {}
    for name in ("unsharded", "mesh"):
        init_state, step = make_lora_train_step(
            cfg, lr=1e-3, mesh=mesh if name == "mesh" else None)
        state = init_state(adapted if name == "mesh" else {
            **adapted, "layers": {k: (LoRAWeight(v.base, v.a.clone(),
                                                 v.b.clone(), v.scale)
                                      if isinstance(v, LoRAWeight) else v)
                                  for k, v in adapted["layers"].items()}})
        torch.cuda.synchronize()
        reset_counts()
        losses, stamps = [], [time.perf_counter()]
        for _ in range(steps):
            state, loss = step(state, toks)
            losses.append(float(loss))
            stamps.append(time.perf_counter())
        counts = read_counts()
        base_equal = all(
            torch.equal(local(state["params"]["layers"][k].base),
                        base["layers"][k])
            for k in ("wq", "wk", "wv", "wo"))
        rows[name] = {"losses": losses, "launches": counts,
                      "step_s": [b - a for a, b in zip(stamps, stamps[1:])],
                      "base_unchanged": base_equal}
        del state
        want = cfg.n_layers * (2 if name == "mesh" else 1)
        expect_counts(f"lora_mesh {name}", counts,
                      {k: steps * want for k in FLASH_KERNELS})
        held_to(f"lora_mesh {name}", name, losses[0], bound)
        if not base_equal:
            raise AssertionError(f"lora_mesh {name}: the base moved")
    torch.cuda.empty_cache()
    emit("lora_mesh", model="gemma_2b", n_layers=cfg.n_layers, rank=8,
         mesh={"fsdp": 2, "model": 2}, B=B, S=S, steps=steps,
         unsharded_loss=bound["loss"], bound=bound["bound"],
         loss_diffs=[a - b for a, b in zip(rows["mesh"]["losses"],
                                           rows["unsharded"]["losses"])],
         launches_per_step={"unsharded": cfg.n_layers, "mesh": 2 * cfg.n_layers},
         unsharded_run=rows["unsharded"], mesh_run=rows["mesh"])
    return {k: rows["mesh"]["launches"][k] + rows["unsharded"]["launches"][k]
            for k in FLASH_KERNELS}


LOCAL_BLOCKS = (  # (name, B, S, H, KV, D, launches a step, path)
    ("llama3_8b fsdp2 x model2 block", 1, 2048, 16, 4, 128, 32,
     "fsdp_tp; pipeline (x4 microbatches: 64)"),
    ("llama3_8b fsdp4 x model2 block", 2, 2048, 16, 4, 128, 32,
     "pipeline's flat step"),
    ("mixtral_8x7b model2 block", 2, 1024, 16, 4, 128, 2, "ep_moe"),
    ("gemma_2b fsdp2 block", 1, 2048, 8, 1, 256, 36, "lora_mesh"),
)


def phase_local_blocks() -> dict:
    """Each new local-block shape's forward (with the lse) and backward
    kernels against their plain versions, timed beside SDPA and the bound
    (``flash_case``/``bwd_case``), and the K1 pair of the seq x fsdp x
    model step (a full pair below the diagonal and the diagonal, S_loc =
    2048 at 16 heads over 4). Returns the cases by kernel."""
    rows = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": [],
            "flash_fwd_block": [], "flash_bwd_dq_block": [],
            "flash_bwd_dkv_block": []}
    for name, B, S, H, KV, D, per_step, path in LOCAL_BLOCKS:
        f = flash_case(name, B, S, H, KV, D, lse=True, timed=True)
        b = bwd_case(name, B, S, H, KV, D, timed=True)
        rows["flash_fwd"].append(f)
        rows["flash_bwd_dq"].append(b["dq"])
        rows["flash_bwd_dkv"].append(b["dkv"])
        emit("local_block", case=name, B=B, S=S, H=H, KV=KV, D=D,
             launches_a_step=per_step, path=path,
             **{f"fwd_{k}": f[k] for k in ("ms", "library_ms", "bound_ms",
                                           "plain_ms")},
             **{f"dq_{k}": b["dq"][k] for k in ("ms", "library_ms", "bound_ms")},
             **{f"dkv_{k}": b["dkv"][k] for k in ("ms", "bound_ms")})
    for q_off in (2048, 0):
        got = block_case(f"llama3_8b seq2 x fsdp2 x model2 pair q_off={q_off}",
                         2048, 16, 4, 128, q_off, 0, timed=True)
        for k, r in zip(("flash_fwd_block", "flash_bwd_dq_block",
                         "flash_bwd_dkv_block"), got):
            rows[k].append(r)
    return rows


# ----- serving over a caller's mesh, MoE under tp, conversion, probe --------

MESH_SHAPE = {"fsdp": 2, "model": 2}
MESH_LLAMA_LAYERS = 8  # of 32


def fsdp_gather_ms(mparams, cfg, smesh) -> float:
    """Device time of one decode step's fsdp gathers alone, by CUDA-graph
    replay: every layer's weights for every model shard
    (``ServingMesh.layer_source``) and the vocab shards of the
    unembedding, the copies the mesh server's decode step makes."""
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import local

    src = smesh.layer_source(mparams["layers"])
    proj = "embed" if cfg.tie_embeddings else "unembed"

    def gathers():
        for i in range(cfg.n_layers):
            src(i)
        for m in range(smesh.tp):
            local(mparams[proj], model=m)

    return graph_ms(gathers, 20)


def mesh_side(params, cfg, kw, prompts, budgets, lens, mesh=None):
    """One server of the serve_mesh phase over ``prompts``: its outputs and
    its row (:func:`serve_row`'s times, shard counters, peak memory, the
    bytes of its params as it holds them, the ``extra_bytes`` of the
    server's own ``kv_replicated`` event, None when it emitted none)."""
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.guest.serving import _tensor_leaves
    from kata_xpu_device_plugin_tpu_torch.obs import flight

    # The server's construction events, on a ring of their own.
    ring = flight.FlightRecorder(256)
    prev = flight.set_default_recorder(ring)
    srv = GenerationServer(params, cfg, **kw, **({"mesh": mesh} if mesh else {}))
    flight.set_default_recorder(prev)
    warned = [e["extra_bytes"] for e in ring.snapshot()
              if e["name"] == "kv_replicated" and e["server"] == srv._label]
    outs, wall, runs, stats = run_requests(srv, prompts, budgets)
    row = tp_row(stats, wall, budgets, lens, runs)
    row.update(peak_mem_bytes=serve_row(stats, wall, budgets, lens,
                                        runs)["peak_mem_bytes"],
               kv_replicated_extra_bytes=warned[0] if warned else None,
               params_bytes=sum(t.nbytes for t in _tensor_leaves(srv.params)))
    del srv
    return outs, row, runs


# The per-shard kernel shapes of the serve_mesh and moe_tp servers (model 2):
# (name, flash (B, S, H, KV, D), paged decode (B, H, KV, D, tile)). Mixtral's
# shard shape is Llama-3-8B's (16 query heads over 4 KV heads, D 128).
MESH_SHARDS = (
    ("gemma_2b model-shard", (1, 1024, 4, 1, 256), (16, 4, 1, 256, 16)),
    ("llama3_8b/mixtral model-shard", (1, 1024, 16, 4, 128), (16, 16, 4, 128, 16)),
)


def phase_mesh_shards() -> dict:
    """The flash forward and the paged decode kernel (int8 pool, tile 16)
    at the model-shard shapes the serve_mesh and moe_tp servers give them
    (:data:`MESH_SHARDS`), against their plain versions, timed beside the
    bound. Returns the cases by kernel."""
    rows = {"flash_fwd": [], "paged_decode": []}
    for name, (B, S, H, KV, D), (Bd, Hd, KVd, Dd, bs) in MESH_SHARDS:
        f = flash_case(f"{name} prefill", B, S, H, KV, D, timed=True)
        d = decode_case(f"{name} decode", Bd, Hd, KVd, Dd, bs, True, timed=True)
        rows["flash_fwd"].append(f)
        rows["paged_decode"].append(d)
        emit("mesh_shard", case=name,
             **{f"fwd_{k}": f[k] for k in ("ms", "library_ms", "bound_ms",
                                           "plain_ms", "max_err_over_bound")},
             **{f"decode_{k}": d[k] for k in ("ms", "bound_ms", "plain_ms",
                                              "max_err_over_bound")})
    return rows


def phase_serve_mesh(seed: int = 0, profile: bool = False) -> dict:
    """Configuration 21 (PERF.md): serving straight from a training layout,
    ``GenerationServer(mesh=build_mesh({"fsdp": 2, "model": 2}))``, every
    shard on the one card, beside the unsharded server on the same
    requests. (a) Gemma-2B, all 18 layers at full width, random bf16 fused
    weights, configuration 2's paged server (int8 KV, 16 lanes, tile 16, 32
    requests): its one KV head does not divide, so the KV replicates
    (``kv_replicated``, JAX's ``extra_bytes``) and each model shard's query
    heads run the paged kernel over it. (b) Llama-3-8B at its widths with
    8 of 32 layers, unfused, 16 requests: its KV heads are cut, the paged
    kernel launches once a shard on its own heads; then the same weights
    born sharded (``init_sharded_params``) served on the same mesh, taken
    as they are and bit-equal in tokens to the mesh server over
    ``shard_params`` of the plain tree. Each mesh run: launches (paged =
    rounds x chunk x layers x model shards), tok/s, TTFT p50, ITL p50/p99
    and peak memory against the unsharded run, ``graph_check`` (replay
    bit-equal to eager), every request's first parting from the unsharded
    server a bf16 flip (:func:`token_partings`), and the fsdp gathers'
    device time a step (:func:`fsdp_gather_ms`) against the step.
    ``profile`` adds a profiled window of the Gemma-2B mesh server's decode
    rounds."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.guest.tp_serving import ServingMesh
    from kata_xpu_device_plugin_tpu_torch.models import (
        fuse_decoder_params,
        gemma_2b,
        init_params,
        llama3_8b,
    )
    from kata_xpu_device_plugin_tpu_torch.models.transformer import tp_serving_params
    from kata_xpu_device_plugin_tpu_torch.parallel.mesh import build_mesh
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import (
        init_sharded_params,
    )

    mesh = build_mesh(MESH_SHAPE)
    launches, failures = {}, []
    for model in ("gemma_2b", "llama3_8b"):
        if model == "gemma_2b":
            cfg = gemma_2b()
            reduced = "none: all 18 layers"
            params = fuse_decoder_params(
                init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16))
            prompts, budgets, lens = phase_requests(32, cfg.vocab_size, seed)
        else:
            cfg = llama3_8b(n_layers=MESH_LLAMA_LAYERS)
            reduced = f"n_layers={MESH_LLAMA_LAYERS} of 32"
            params = init_params(cfg, seed=seed, device="cuda",
                                 dtype=torch.bfloat16)
            prompts, budgets, lens = phase_requests(16, cfg.vocab_size, seed)
        kw = dict(**PAGED_KW, **SERVE_KW)
        outs1, row1, _ = mesh_side(params, cfg, kw, prompts, budgets, lens)
        torch.cuda.empty_cache()
        outs, row, runs = mesh_side(params, cfg, kw, prompts, budgets, lens,
                                    mesh)
        add_launches(launches, runs)
        torch.cuda.empty_cache()
        if row["tp_degree"] != MESH_SHAPE["model"]:
            failures.append(f"{model}: tp_degree {row['tp_degree']}")
        replicated = cfg.n_kv_heads % MESH_SHAPE["model"] != 0
        if (row["kv_replicated_extra_bytes"] is not None) != replicated:
            failures.append(f"{model}: kv_replicated {row['kv_replicated_extra_bytes']}")
        smesh = ServingMesh.for_mesh(cfg, mesh)
        mparams = tp_serving_params(params, cfg, smesh)
        gather_ms = fsdp_gather_ms(mparams, cfg, smesh)
        del mparams
        gc_row = graph_check(params, cfg, dict(kw, mesh=mesh), seed=seed)
        parts = token_partings(params, cfg, prompts, outs, outs1, quantized=True)
        if not parts["all_flips"]:
            failures.append(f"{model}: a parting from the unsharded server is "
                            f"not a flip {parts}")
        sharded = None
        if model == "llama3_8b":
            born = init_sharded_params(cfg, mesh, seed=seed, dtype=torch.bfloat16)
            srv = GenerationServer(born, cfg, **kw, mesh=mesh)
            taken = srv.params["layers"]["wq"] is born["layers"]["wq"]
            outs_b, wall_b, runs_b, stats_b = run_requests(srv, prompts, budgets)
            del srv, born
            torch.cuda.empty_cache()
            add_launches(launches, runs_b)
            same = token_match(outs_b, outs, budgets)
            sharded = {"pieces_taken_as_they_are": taken,
                       "tok_s": round(int(sum(budgets)) / wall_b, 2),
                       "token_match_vs_mesh_of_plain": same}
            if not taken or same["requests_identical"] != len(budgets):
                failures.append(f"{model}: init_sharded_params tree {sharded}")
        itl = row["itl_p50_s"] * 1e3
        emit("serve_mesh", model=model, reduced=reduced, mesh=MESH_SHAPE,
             config=dict(kw), prompt_lens=lens.tolist(), unsharded=row1,
             mesh_server=row,
             vs_unsharded={
                 "tok_s": round(row["tok_s"] / row1["tok_s"], 4),
                 "itl_p50": round(row["itl_p50_s"] / row1["itl_p50_s"], 4),
                 "ttft_p50": round(row["ttft_p50_s"] / row1["ttft_p50_s"], 4)},
             fsdp_gather_ms_per_step=round(gather_ms, 5),
             fsdp_gather_share_of_itl_p50=round(gather_ms / itl, 4),
             graph_check=gc_row["outputs_bit_equal"] and gc_row["arena_bit_equal"],
             token_match_vs_unsharded=token_match(outs, outs1, budgets),
             partings=parts, sharded_tree=sharded)
        if profile and model == "gemma_2b":
            profile_rounds(params, cfg, dict(kw, mesh=mesh),
                           np.random.default_rng(seed), lanes=16,
                           model="gemma_2b over fsdp 2 x model 2")
        del params
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("serve_mesh: " + "; ".join(failures))
    return launches


# The moe_tp layer check's capacity factors: Mixtral's own (2.0) and one
# at which the prefill's copies overflow some experts' buffers.
MOE_TP_FACTORS = (2.0, 1.0)


def tp_moe_layer_check(params, cfg, prompts, buckets, max_len: int) -> dict:
    """The ``tp=2`` serving MoE layer (:func:`..ops.moe.moe_ffn_tp`: each
    shard's experts on the one global dispatch, the shards' combines
    summed) against ``moe_ffn`` over the whole stacks on the card, on the
    last layer's recorded prefill and decode inputs (as
    :func:`moe_layer_check` records them), at each capacity factor of
    :data:`MOE_TP_FACTORS`, where copies may drop: each token's largest
    error within :data:`MOE_LAYER_TOL` of its largest output (both sides
    route and drop alike; only the order of the fp32 sums and the expert
    GEMMs' batching differ). The copies routed and dropped by the global
    capacity are counted."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import (
        forward,
        map_leaf,
        prefill_batch,
    )
    from kata_xpu_device_plugin_tpu_torch.ops import moe
    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention

    lens = [len(p) for p in prompts]
    pad = next(b for b in buckets if b >= max(lens))
    toks = torch.zeros((len(prompts), pad), dtype=torch.int32, device="cuda")
    for i, p in enumerate(prompts):
        toks[i, :lens[i]] = torch.from_numpy(np.asarray(p, np.int32))
    seen, real = [], moe.moe_ffn

    def recording(p, x, c):
        seen.append(x.detach().clone())
        return real(p, x, c)

    moe.moe_ffn = recording
    try:
        caches, logits, pos = prefill_batch(
            params, toks, cfg, max_len, torch.tensor(lens, dtype=torch.int32),
            kv_quantized=True)
        first = torch.argmax(logits, -1).to(torch.int32)
        forward(params, first[:, None], cfg, attn_fn=reference_attention,
                positions=pos[:, None], kv_caches=caches, cache_offset=pos)
    finally:
        moe.moe_ffn = real
    L, last = cfg.n_layers, cfg.n_layers - 1
    layer = params["layers"]
    whole = {"router": layer["router"][last]}
    whole.update({k: map_leaf(lambda t: t[last], layer[f"moe_{k}"])
                  for k in ("w_gate", "w_in", "w_out")})
    n = cfg.moe_num_experts // 2
    shards = {"router": whole["router"]}
    shards.update({k: [map_leaf(lambda t, s=s: t[s * n:(s + 1) * n].contiguous(),
                                whole[k]) for s in range(2)]
                   for k in ("w_gate", "w_in", "w_out")})
    row = {"layer": last, "tol_x_token_max": MOE_LAYER_TOL, "cases": []}
    for factor in MOE_TP_FACTORS:
        mcfg = replace(cfg.moe_cfg(), capacity_factor=factor)
        for what, x in (("prefill", seen[last].reshape(-1, cfg.d_model)),
                        ("decode", seen[L + last].reshape(-1, cfg.d_model))):
            got, _ = moe.moe_ffn_tp(shards, x, mcfg)
            want, _ = moe.moe_ffn(whole, x, mcfg)
            err = (got.float() - want.float()).abs().amax(-1)
            top = want.float().abs().amax(-1).clamp_min(2.0 ** -30)
            _g, experts, _p = moe._route(whole, x, mcfg)
            counts = torch.bincount(experts.reshape(-1),
                                    minlength=mcfg.num_experts)
            cap = moe.capacity(mcfg, x.shape[0])
            kept = int(counts.clamp(max=cap).sum())
            row["cases"].append({
                "inputs": what, "capacity_factor": factor,
                "tokens": x.shape[0], "capacity": cap,
                "copies": int(experts.numel()),
                "dropped": int(experts.numel()) - kept,
                "bit_equal": bool(torch.equal(got, want)),
                "max_abs_err": float(err.max()),
                "max_err_over_token_max": float((err / top).max())})
    row["dropped"] = sum(c["dropped"] for c in row["cases"])
    row["ok"] = all(c["max_err_over_token_max"] <= MOE_LAYER_TOL
                    for c in row["cases"])
    return row


def phase_moe_tp(seed: int = 0) -> dict:
    """Configuration 22 (PERF.md): MoE under tensor-parallel serving.
    Mixtral-8x7B at its widths with 4 of 32 layers, configuration 14's
    server (paged, int8 KV, 16 lanes, tile 16, 16 requests, Mixtral's
    capacity factor 2.0) at ``tp=2`` (the expert stacks cut over the
    shards, 4 experts each, the router whole; each shard's query heads
    over its own KV heads) beside ``tp=1``, with bf16 and then int8
    experts. The timed runs: launches (paged = rounds x chunk x layers x
    2), tok/s, ITL and TTFT against tp=1, tokens against tp=1 (printed),
    ``graph_check`` (replay bit-equal to eager, the MoE dispatch and its
    drops inside) and :func:`tp_moe_layer_check` (the tp=2 layer against
    ``moe_ffn`` at 2.0 and 1.0, drops counted). At 2.0 a decode step's
    drops depend on every lane's routing, so once two runs part, the other
    lanes' tokens may part by drops no single-request plain step has:
    the token check serves both degrees again, untimed, at a capacity
    factor of E/K (no copy drops; a request's tokens depend on its own
    context), where every first parting from tp=1 must be a bf16 flip
    (:func:`token_partings`, with the tp=2 split of the weights for its
    routing-flip witness). The witness of batch-dependent drops (bf16,
    printed): tp=1 served again with request 0's budget cut to 4, at 2.0
    and at E/K; the other requests' tokens against the full run."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.guest.tp_serving import ServingMesh
    from kata_xpu_device_plugin_tpu_torch.models import init_params, mixtral_8x7b
    from kata_xpu_device_plugin_tpu_torch.models.transformer import tp_serving_params
    from kata_xpu_device_plugin_tpu_torch.ops.quant import quantize_decoder_params

    cfg = mixtral_8x7b(n_layers=MIXTRAL_LAYERS)
    ample = replace(cfg, moe_capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    params = init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16)
    max_len = 2048
    buckets = (128, 256, 512, 1024)
    kw = dict(max_batch=16, max_len=max_len, prefill_buckets=buckets, chunk=8,
              kv_pool_tokens=16 * max_len + 32, kv_block_size=16,
              heartbeat_rounds=HEARTBEAT_ROUNDS)
    prompts, budgets, lens = phase_requests(16, cfg.vocab_size, seed)
    launches, failures = {}, []

    def serve(c, tp, bud=budgets):
        srv = GenerationServer(params, c, **kw, tp=tp)
        out = run_requests(srv, prompts, bud)
        del srv
        torch.cuda.empty_cache()
        return out

    for experts in ("bf16", "int8"):
        if experts == "int8":
            params = quantize_decoder_params(params)
            torch.cuda.empty_cache()
        rows, outs, checked = {}, {}, {}
        for tp in (1, 2):
            outs[tp], wall, runs, stats = serve(cfg, tp)
            rows[tp] = tp_row(stats, wall, budgets, lens, runs)
            if tp == 2:
                add_launches(launches, runs)
            checked[tp] = serve(ample, tp)[0]
        split = tp_serving_params(params, ample,
                                  ServingMesh.for_config(ample, 2, "cuda"))
        parts = token_partings(params, ample, prompts, checked[2], checked[1],
                               quantized=True, split=split)
        del split
        if not parts["all_flips"]:
            failures.append(f"{experts}: a parting from tp=1 is not a flip {parts}")
        drops_witness = None
        if experts == "bf16":
            cut = budgets.copy()
            cut[0] = 4
            drops_witness = {"request_0_budget": [int(budgets[0]), 4]}
            for name, c, full in (("factor_2", cfg, outs[1]),
                                  ("factor_e_over_k", ample, checked[1])):
                got = serve(c, 1, cut)[0]
                drops_witness[name] = token_match(got[1:], full[1:], budgets[1:])
        gc_row = graph_check(params, cfg, dict(kw, tp=2), seed=seed)
        layer_row = tp_moe_layer_check(params, cfg, prompts, buckets, max_len)
        if not layer_row["ok"]:
            failures.append(f"{experts}: tp=2 MoE layer against moe_ffn {layer_row}")
        emit("moe_tp", model="mixtral_8x7b", experts=experts,
             reduced=f"n_layers={MIXTRAL_LAYERS} of 32",
             served_capacity_factor=cfg.moe_capacity_factor, config=dict(kw),
             prompt_lens=lens.tolist(), tp1=rows[1], tp2=rows[2],
             tp2_vs_tp1={"tok_s": round(rows[2]["tok_s"] / rows[1]["tok_s"], 4),
                         "itl_p50": round(rows[2]["itl_p50_s"]
                                          / rows[1]["itl_p50_s"], 4),
                         "ttft_p50": round(rows[2]["ttft_p50_s"]
                                           / rows[1]["ttft_p50_s"], 4)},
             token_match_vs_tp1=token_match(outs[2], outs[1], budgets),
             token_check_capacity_factor=ample.moe_capacity_factor,
             token_check_match_vs_tp1=token_match(checked[2], checked[1], budgets),
             partings=parts, drops_witness=drops_witness,
             graph_check=gc_row["outputs_bit_equal"] and gc_row["arena_bit_equal"],
             moe_layer_tp2=layer_row)
    del params
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("moe_tp: " + "; ".join(failures))
    return launches


@contextlib.contextmanager
def peak_rss():
    """The process's peak resident bytes above its start while the block
    runs, sampled from ``/proc/self/statm`` every 5 ms (a dict filled on
    exit)."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    out, stop = {"start": rss(), "peak": 0}, threading.Event()

    def sample():
        while not stop.is_set():
            out["peak"] = max(out["peak"], rss())
            stop.wait(0.005)

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()
        out["peak"] = max(out["peak"], rss())
        out["peak_above_start_bytes"] = out["peak"] - out["start"]


def phase_convert(seed: int = 0) -> dict:
    """Configuration 23 (PERF.md): the HF conversion in memory, no files.
    Gemma-2B at full width (random bf16 weights) through
    ``to_hf_state_dict`` then ``from_hf`` back onto the card: every leaf
    and the config equal (Gemma's norms carry no offset, so the round trip
    is exact), then 8 requests served from each tree by the slotted serve
    configuration, tokens bit-equal. Then Llama-3-8B's widths at 2 layers
    (its norms go through the ``w - 1`` offset in fp32 and back to bf16):
    the converted tree's prefill logits against the original's within the
    serving bound. Printed: each direction's seconds and the host's peak
    resident bytes above its start."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models import (
        from_hf,
        gemma_2b,
        init_params,
        llama3_8b,
        to_hf_state_dict,
    )
    from kata_xpu_device_plugin_tpu_torch.models.transformer import prefill
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves

    failures, rows = [], {}
    for model, family, cfg in (("gemma_2b", "gemma", gemma_2b()),
                               ("llama3_8b", "llama", llama3_8b(n_layers=2))):
        params = init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        with peak_rss() as mem_out:
            t0 = time.perf_counter()
            sd, hf_cfg = to_hf_state_dict(params, cfg, family)
            out_s = time.perf_counter() - t0
        with peak_rss() as mem_in:
            t0 = time.perf_counter()
            back, bcfg = from_hf(sd, hf_cfg, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            in_s = time.perf_counter() - t0
        del sd
        row = {"hf_config": hf_cfg, "state_dict_to_hf_s": round(out_s, 3),
               "from_hf_s": round(in_s, 3),
               "to_hf_peak_rss_above_start_bytes": mem_out["peak_above_start_bytes"],
               "from_hf_peak_rss_above_start_bytes": mem_in["peak_above_start_bytes"],
               "config_equal": bcfg == cfg}
        if not row["config_equal"]:
            failures.append(f"{model}: config {bcfg} != {cfg}")
        pairs = list(zip(leaves(params), leaves(back)))
        row["leaves_bit_equal"] = sum(torch.equal(a, b) for a, b in pairs)
        row["leaves"] = len(pairs)
        if model == "gemma_2b":
            if row["leaves_bit_equal"] != row["leaves"]:
                failures.append(f"{model}: round trip changed "
                                f"{row['leaves'] - row['leaves_bit_equal']} leaves")
            prompts, budgets, lens = phase_requests(8, cfg.vocab_size, seed)
            kw = dict(max_batch=8, **SERVE_KW)
            got = []
            for tree in (params, back):
                srv = GenerationServer(tree, cfg, **kw)
                rids = [srv.submit(p, int(b)) for p, b in zip(prompts, budgets)]
                res = srv.run()
                got.append([res[r] for r in rids])
                del srv
            row["served"] = token_match(got[1], got[0], budgets)
            if row["served"]["requests_identical"] != len(budgets):
                failures.append(f"{model}: converted tree served other tokens "
                                f"{row['served']}")
        else:
            rng = np.random.default_rng(seed)
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 512))).to("cuda")
            want = prefill(params, toks, cfg, 512, return_logits=True)[1].float()
            have = prefill(back, toks, cfg, 512, return_logits=True)[1].float()
            rms = float(want.square().mean().sqrt())
            err = float((have - want).abs().max())
            row["prefill_logits"] = {"max_abs_err": err, "logit_rms": rms,
                                     "err_x_rms": err / rms,
                                     "bound_x_rms": LOGIT_BOUND["prefill"]}
            if err > LOGIT_BOUND["prefill"] * rms:
                failures.append(f"{model}: converted logits {row['prefill_logits']}")
        rows[model] = row
        del params, back
        torch.cuda.empty_cache()
    emit("convert", **rows)
    if failures:
        raise AssertionError("convert: " + "; ".join(failures))
    return rows


def phase_probe() -> dict:
    """Configuration 24 (PERF.md): the guest's validation ladder on the
    card, ``run_ladder(expected_devices=torch.cuda.device_count())``: its
    three JSON lines (devices, a 256 x 256 bf16 product, the all-reduce),
    every check ``ok``."""
    import io

    import torch

    from kata_xpu_device_plugin_tpu_torch.guest.probe import run_ladder

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_ladder(expected_devices=torch.cuda.device_count())
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    for line in lines:
        emit("probe", **line)
    if rc != 0 or len(lines) != 3 or not all(x["ok"] for x in lines):
        raise AssertionError(f"probe: rc {rc}, {lines}")
    return {x["check"]: x["ok"] for x in lines}


# Configuration 25 (PERF.md): the GPU daemon's knobs for the guest it
# hands a card to, and the guest's serving run under them.
HOST_KNOBS = dict(kv_quant="int8", decode_steps=8, kv_pool_tokens=8000,
                  heartbeat_rounds=4)
HOST_REQUESTS = 8
HOST_TIMEOUT_S = 600


def _smi_gpus() -> list:
    """``nvidia-smi``'s view of each card: ``(BDF or None, device id or
    None, minor)``; ``[N/A]`` where the machine hides a field."""
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=pci.bus_id,pci.device_id",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    query = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True,
                           check=True, timeout=60).stdout
    minors = [int(line.split(":")[1]) for line in query.splitlines()
              if line.strip().startswith("Minor Number")
              and line.split(":")[1].strip().isdigit()]
    out = []
    for row, minor in zip(rows, minors):
        bus, dev = (f.strip() for f in row.split(","))
        known = [v if not v.startswith("[") else None for v in (bus, dev)]
        # pci.device_id is the device and vendor ids as one word, 0x233010DE.
        out.append((known[0], known[1][2:6].lower() if known[1] else None, minor))
    if len(out) != len(rows):
        raise AssertionError(f"nvidia-smi: {len(rows)} cards, minors {minors}")
    return out


def host_daemon(expected: int, work: str) -> dict:  # torchguard: allow(TL004) the daemon never initializes CUDA: its windows time host work
    """The daemon side of configuration 25, in a process of its own that
    never initializes CUDA (asserted before the guest starts and after it
    ends). Discovery over the machine's real /sys, /dev and /proc against
    ``nvidia-smi``; the VFIO scan; the manager writing the JSON CDI spec,
    read back and checked; an Allocate over the plugin's socket with
    :data:`HOST_KNOBS`; the guest child (:func:`host_guest`) started with
    exactly that allocation's env; the guest's heartbeat stream
    aggregated under the granted device id. Returns the phase's fields."""
    import grpc
    import torch

    from kata_xpu_device_plugin_tpu_torch import cdi
    from kata_xpu_device_plugin_tpu_torch.cdi import constants as C
    from kata_xpu_device_plugin_tpu_torch.config import Config
    from kata_xpu_device_plugin_tpu_torch.discovery import (
        normalize_bdf, scan_gpus, scan_pci, scan_vfio)
    from kata_xpu_device_plugin_tpu_torch.discovery.gpu import proc_gpu_minors
    from kata_xpu_device_plugin_tpu_torch.plugin import PluginManager
    from kata_xpu_device_plugin_tpu_torch.plugin.api import deviceplugin_pb2 as pb
    from kata_xpu_device_plugin_tpu_torch.plugin.api import glue
    from kata_xpu_device_plugin_tpu_torch.utils import metrics

    failures, row = [], {}

    def no_context(when: str) -> None:
        if torch.cuda.is_initialized():
            failures.append(f"the daemon initialized CUDA ({when})")

    t0 = time.perf_counter()
    inv = scan_gpus()
    row["scan_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    smi = _smi_gpus()
    row["gpus"] = [dict(index=c.index, dev_path=c.dev_path, major=c.major,
                        minor=c.minor, pci_address=c.pci_address,
                        pci_device=c.pci_device, numa_node=c.numa_node)
                   for c in inv.chips]
    row["nvidia_smi_gpus"] = [dict(bus_id=b, device_id=d, minor=m) for b, d, m in smi]
    row["model"] = inv.model_suffix
    if inv.count != expected:
        failures.append(f"scan found {inv.count} GPUs, CUDA counts {expected}")
    if sorted(c.index for c in inv.chips) != sorted(m for _, _, m in smi):
        failures.append("scan's minors are not nvidia-smi's")
    by_minor = {m: (b, d) for b, d, m in smi}
    # What this machine lets the phase check, said as such rather than
    # passed: without the driver's procfs the scan takes its sandbox
    # branch; where nvidia-smi hides the bus and device ids there is no
    # PCI identity to hold the scan's against; without a PCI tree the VFIO
    # scan has nothing to leave out.
    row["procfs_minors_checked"] = proc_gpu_minors() is not None
    row["pci_identity_checked"] = bool(smi) and all(b and d for b, d, _ in smi)
    row["vfio_checked"] = bool(scan_pci())
    for c in inv.chips:
        st = os.stat(c.dev_path)
        if not (stat.S_ISCHR(st.st_mode) and os.major(st.st_rdev) == C.GPU_DEVICE_MAJOR
                and os.minor(st.st_rdev) == c.index):
            failures.append(f"{c.dev_path} is not char device 195:{c.index}")
        bus, dev = by_minor.get(c.index, (None, None))
        if row["pci_identity_checked"] and (
                normalize_bdf(bus) != c.pci_address or dev != c.pci_device):
            failures.append(f"GPU {c.index}: scan {c.pci_address} {c.pci_device}, "
                            f"nvidia-smi {bus} {dev}")
    vfio = scan_vfio(vendors=("10de",))
    row["vfio_groups"] = len(vfio.groups)
    ours = {c.pci_address for c in inv.chips if c.pci_address}
    if row["vfio_checked"] and any(
            d.address in ours for devs in vfio.groups.values() for d in devs):
        failures.append("a GPU the nvidia driver holds is listed as vfio-bound")

    kubelet = stand_in_kubelet(os.path.join(work, "k"))
    events = os.path.join(work, "events")
    cfg = Config(cdi_dir=os.path.join(work, "cdi"), cdi_format="json",
                 kubelet_socket_dir=kubelet.socket_dir,
                 state_dir=os.path.join(work, "state"),
                 rescan_interval_s=0, metrics_port=0, guest_events_dir=events,
                 **HOST_KNOBS)
    mgr = PluginManager(cfg)
    try:
        t0 = time.perf_counter()
        mgr.start()
        row["start_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        if not kubelet.wait_registrations(1, 10):
            failures.append("the plugin did not register")
        t0 = time.perf_counter()
        (path,) = mgr.write_specs()
        row["spec_write_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        spec = cdi.load(path)
        nodes = [n.host_path for n in spec.container_edits.device_nodes] + [
            n.host_path for d in spec.devices for n in d.container_edits.device_nodes]
        row["spec"] = dict(path=os.path.basename(path), kind=spec.kind,
                           devices=spec.device_names(), nodes=nodes)
        if (spec.kind != C.DEFAULT_KIND
                or spec.device_names() != [str(c.index) for c in inv.chips]
                or not all(os.path.exists(n) for n in nodes)):
            failures.append(f"CDI spec: {row['spec']}")
        index = str(inv.chips[0].index)
        with grpc.insecure_channel(
                f"unix://{mgr.plugins()[0].socket_path}") as ch:
            stub = glue.DevicePluginStub(ch)
            req = pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(device_ids=[index])])
            stub.Allocate(req)  # the channel's first call connects
            t0 = time.perf_counter()
            resp = stub.Allocate(req)
            row["allocate_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        t0 = time.perf_counter()
        mgr.gpu_allocator().allocate([index])
        row["allocator_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        envs = dict(resp.container_responses[0].envs)
        row["envs"] = envs
        want = {C.ENV_KV_QUANT: "int8", C.ENV_DECODE_STEPS: "8",
                C.ENV_KV_POOL_TOKENS: "8000", C.ENV_HEARTBEAT_ROUNDS: "4",
                C.ENV_TPU_VISIBLE_CHIPS: index, C.ENV_OBS: "1"}
        if any(envs.get(k) != v for k, v in want.items()):
            failures.append(f"Allocate env {envs}")
        no_context("before the guest")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KATA_TPU_", "KATATPU_"))}
        env.update(envs)
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                                "--host-guest"], env=env, cwd=HERE,
                               capture_output=True, text=True, timeout=HOST_TIMEOUT_S)
        row["guest_s"] = round(time.perf_counter() - t0, 2)
        no_context("after the guest")
        lines = [json.loads(x) for x in child.stdout.splitlines() if x.startswith("{")]
        guest = next((x for x in lines if x.get("phase") == "host_guest"), None)
        if child.returncode != 0 or guest is None:
            raise AssertionError(f"host: guest rc {child.returncode}\n"
                                 f"{child.stdout[-3000:]}\n{child.stderr[-3000:]}")
        row["guest"] = guest
        if guest["trace"] != envs[C.ENV_TRACE_CTX]:
            failures.append("the guest did not adopt the allocation's trace")
        # The manager's aggregator thread tails the stream while the guest
        # runs; one more pass takes what it has not yet read. Its counter
        # holds every heartbeat either pass consumed.
        agg = mgr.aggregator
        agg.poll_once()
        row["aggregated"] = agg.snapshot()
        keys = list(row["aggregated"])
        row["heartbeats_aggregated"] = sum(
            metrics.guest_heartbeats_total.labels(
                allocation=k.split("/", 1)[0], server=k.split("/", 1)[1]).get()
            for k in keys)
        if (row["heartbeats_aggregated"] != guest["heartbeats"]
                or row["heartbeats_aggregated"] < 1
                or not keys or not all(k.startswith(f"{index}/") for k in keys)):
            failures.append(f"aggregated {row['heartbeats_aggregated']} heartbeats "
                            f"as {keys}, guest emitted {guest['heartbeats']}")
    finally:
        mgr.stop()
        kubelet.stop()
    no_context("at the end")
    row["cuda_initialized"] = torch.cuda.is_initialized()
    if failures:
        raise AssertionError("host: " + "; ".join(failures))
    return row


def host_guest() -> dict:
    """The guest side of configuration 25: a process started with exactly
    the allocation's env. The probe ladder, then Gemma-2B (all 18 layers)
    served by a ``GenerationServer`` that takes its KV dtype, pool, decode
    steps and heartbeat from that env: :data:`HOST_REQUESTS` requests
    through :func:`run_requests` (the launch rule), the knobs in
    ``stats()``, every event of its stream under the allocation's trace,
    then ``graph_check`` (replay bit-equal to eager)."""
    import io

    import torch

    from kata_xpu_device_plugin_tpu_torch import obs
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.guest.probe import run_ladder

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_ladder(expected_devices=1)
    ladder = [json.loads(x) for x in buf.getvalue().splitlines()]
    if rc != 0 or len(ladder) != 3 or not all(x["ok"] for x in ladder):
        raise AssertionError(f"host guest probe: rc {rc}, {ladder}")
    params, cfg = gemma_setup()
    kw = dict(max_batch=HOST_REQUESTS, **SERVE_KW)
    srv = GenerationServer(params, cfg, **kw)
    prompts, budgets, lens = phase_requests(HOST_REQUESTS, cfg.vocab_size, seed=7)
    outs, wall, launches, stats = run_requests(srv, prompts, budgets)
    trace = os.environ["KATA_TPU_TRACE_CTX"]
    knobs = {k: stats[k] for k in ("kv_quant", "decode_steps", "kv_pool_tokens",
                                   "heartbeat_rounds", "trace", "decode_backend")}
    want = dict(kv_quant="int8", decode_steps=8, heartbeat_rounds=4, trace=trace,
                decode_backend="cuda_paged")
    if any(knobs[k] != v for k, v in want.items()) or not stats["kv_pool_tokens"]:
        raise AssertionError(f"host guest: the server did not take the env: {knobs}")
    row = dict(probe={x["check"]: x["ok"] for x in ladder}, knobs=knobs,
               trace=stats["trace"], heartbeats=stats["heartbeats"],
               **serve_row(stats, wall, budgets, lens, launches))
    del srv
    torch.cuda.empty_cache()
    # A chunk is chunk x decode_steps = 64 steps here: budgets of two
    # chunks and more keep the lanes live through the checked chunk.
    steps = SERVE_KW["chunk"] * HOST_KNOBS["decode_steps"]
    row["graph_check"] = graph_check(params, cfg, kw, budget=2 * steps + 8)
    if not row["graph_check"]["lanes"]:
        raise AssertionError("host guest: graph_check ran no live lane")
    sink = obs.default_sink()
    sink.close()
    evs = obs.read_events(os.environ["KATATPU_OBS_FILE"])
    row["events"] = len(evs)
    row["event_traces"] = sorted({e.get("trace") for e in evs})
    if not evs or row["event_traces"] != [trace]:
        raise AssertionError(f"host guest: events under {row['event_traces']}")
    return row


def host_work_dir() -> str:
    """A fresh directory for the host phase's sockets and files: under the
    temp dir, else the checkout's ``build/``, whichever leaves a unix
    socket path below it inside its 107 bytes (a plugin socket's name is
    about 40 bytes)."""
    for base in (tempfile.gettempdir(), os.path.join(HERE, "build")):
        if len(base) <= 48:
            os.makedirs(base, exist_ok=True)
            return tempfile.mkdtemp(prefix="kh-", dir=base)
    return tempfile.mkdtemp(prefix="kh-", dir="/tmp")


def phase_host(smi: str) -> dict:
    """Configuration 25 (PERF.md): the GPU daemon on this machine's real
    /sys, /dev and /proc, and Gemma-2B served on the card under the
    daemon's allocation. This process holds a CUDA context since the
    first phase, so the daemon side runs in a fresh one
    (``chip_smoke.py --host-daemon``, :func:`host_daemon`), which starts
    the guest (``--host-guest``, :func:`host_guest`) with the allocation's
    env. Returns the guest run's kernel launches."""
    import torch

    work = host_work_dir()
    try:
        res = subprocess.run(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--host-daemon",
             str(torch.cuda.device_count()), work],
            capture_output=True, text=True, cwd=HERE, timeout=HOST_TIMEOUT_S + 120)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    row = next((x for x in lines if x.get("phase") == "host_daemon"), None)
    if res.returncode != 0 or row is None:
        raise AssertionError(f"host: daemon rc {res.returncode}\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    del row["phase"]
    emit("host", nvidia_smi=smi, **row)
    return row["guest"]["launches"]


# ----- multi-host membership, pod-resources, loader strides (config 26) -----

# Configuration 26 (PERF.md): two daemons on one card machine as workers 0
# and 1 of one two-host membership, each resolving it from another source.
MULTIHOST_HOSTS = ("127.0.0.1", "localhost")
MULTIHOST_ENDPOINTS = "0:127.0.0.1:8476,1:localhost:8476"
MULTIHOST_MODEL = "gemma_2b_bench"
MULTIHOST_REQUESTS = 8
# The global batch the two guests stride: rows of MULTIHOST_SEQ + 1 tokens.
MULTIHOST_BATCH, MULTIHOST_SEQ, MULTIHOST_STEPS = 8, 15, 2
MULTIHOST_TIMEOUT_S = 600
NCCL_NOTE = ("no NCCL group: NCCL refuses two ranks on one device, so the "
             "NCCL group across cards waits for ROADMAP item 10")


def stand_in_kubelet(kdir: str):
    """A stand-in kubelet on ``<kdir>/kubelet.sock``: Registration (each
    request kept) and pod-resources ``List``, which answers with the
    devices :meth:`grant` recorded. ``.stop()`` ends its server."""
    import threading
    from concurrent import futures

    import grpc

    from kata_xpu_device_plugin_tpu_torch.plugin.api import deviceplugin_pb2 as pb
    from kata_xpu_device_plugin_tpu_torch.plugin.api import glue
    from kata_xpu_device_plugin_tpu_torch.plugin.api import podresources_pb2 as prpb

    class Kubelet(glue.RegistrationServicer, glue.PodResourcesListerServicer):
        def __init__(self):
            self.socket_dir = kdir
            self.socket_path = os.path.join(kdir, "kubelet.sock")
            self.registrations = []
            self.changed = threading.Condition()
            self.pods = prpb.ListPodResourcesResponse()
            self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))

        def Register(self, request, context):  # noqa: N802 - the API's name
            with self.changed:
                self.registrations.append(request)
                self.changed.notify_all()
            return pb.Empty()

        def List(self, request, context):  # noqa: N802 - the API's name
            return self.pods

        def wait_registrations(self, n: int, timeout: float) -> bool:
            with self.changed:
                return self.changed.wait_for(
                    lambda: len(self.registrations) >= n, timeout)

        def grant(self, pod: str, resource: str, ids: list) -> None:
            self.pods.pod_resources.add(
                name=pod, namespace="default",
                containers=[prpb.ContainerResources(name="guest", devices=[
                    prpb.ContainerDevices(resource_name=resource,
                                          device_ids=ids)])])

        def stop(self) -> None:
            self.server.stop(grace=1).wait()

    kubelet = Kubelet()
    os.makedirs(kdir)
    glue.add_registration_to_server(kubelet, kubelet.server)
    glue.add_pod_resources_to_server(kubelet, kubelet.server)
    kubelet.server.add_insecure_port(f"unix://{kubelet.socket_path}")
    kubelet.server.start()
    return kubelet


def _daemon_env() -> dict:
    """This process's env without the daemon's knobs and any node identity,
    so each daemon resolves only what its flags name."""
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("KATA_TPU_", "KATATPU_", "TPU_", "GLOO_"))}


def multihost_daemons(work: str) -> dict:  # torchguard: allow(TL004) the daemons never initialize CUDA: its windows time host work
    """The host side of configuration 26, in a process that never
    initializes CUDA. Two daemons (``python -m kata_xpu_device_plugin_tpu_torch
    run``, wrapped by ``chip_smoke.py --multihost-daemon``, which reports
    whether the daemon initialized CUDA) as workers 0 and 1 of one
    membership, each with its own state, CDI and socket dirs and stand-in
    kubelet: worker 0 resolves through ``--worker-hostnames`` and
    ``--node-name``, worker 1 through a metadata dir. Their JSON specs
    must carry one hostname list and the ids 0 and 1; one Allocate each;
    ``status --json`` of each lists its pod assignment from the kubelet's
    pod-resources and leaves the state file's bytes and mtime as they
    were; worker 1, restarted with its metadata dir emptied, keeps id 1
    from its state file. Then a guest per worker (``--multihost-guest``)
    with its spec's env and its allocation's: a gloo rendezvous at worker
    0's address, each its loader stride, and worker 0's guest serving
    :data:`MULTIHOST_MODEL` on the card."""
    import glob
    import signal
    import socket

    import grpc
    import torch

    from kata_xpu_device_plugin_tpu_torch import cdi
    from kata_xpu_device_plugin_tpu_torch.cdi import constants as C
    from kata_xpu_device_plugin_tpu_torch.discovery import scan_gpus
    from kata_xpu_device_plugin_tpu_torch.multihost.resolver import (
        ATTR_WORKER_ENDPOINTS,
        ATTR_WORKER_NUMBER,
        STATE_FILE,
    )
    from kata_xpu_device_plugin_tpu_torch.plugin.api import deviceplugin_pb2 as pb
    from kata_xpu_device_plugin_tpu_torch.plugin.api import glue

    failures, row = [], {"hosts": list(MULTIHOST_HOSTS), "nccl": NCCL_NOTE}
    index = str(scan_gpus().chips[0].index)
    md = os.path.join(work, "md1")
    os.makedirs(md)
    for name, text in ((ATTR_WORKER_ENDPOINTS, MULTIHOST_ENDPOINTS),
                       (ATTR_WORKER_NUMBER, "1")):
        with open(os.path.join(md, name), "w") as f:
            f.write(text)
    kubelets, flags, procs, logs = [], [], {}, {}
    for w in (0, 1):
        wdir = os.path.join(work, f"w{w}")
        kubelets.append(stand_in_kubelet(os.path.join(wdir, "k")))
        flags.append([
            "--cdi-dir", os.path.join(wdir, "cdi"), "--cdi-format", "json",
            "--kubelet-socket-dir", kubelets[w].socket_dir,
            "--pod-resources-socket", kubelets[w].socket_path,
            "--state-dir", os.path.join(wdir, "state"), "--metrics-port", "0",
            "--rescan-interval-s", "0", "--kv-quant", "int8",
            "--log-format", "json",
            *(["--worker-hostnames", ",".join(MULTIHOST_HOSTS),
               "--node-name", MULTIHOST_HOSTS[0]] if w == 0
              else ["--metadata-dir", md])])

    def start(w: int, run: int) -> None:
        logs[w] = os.path.join(work, f"daemon{w}.{run}")
        with open(logs[w] + ".log", "w") as err:
            procs[w] = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--multihost-daemon", logs[w] + ".json", "run", *flags[w]],
                env=_daemon_env(), cwd=HERE, stdout=subprocess.DEVNULL,
                stderr=err)

    def stop(w: int) -> None:
        procs[w].send_signal(signal.SIGTERM)
        rc = procs[w].wait(timeout=60)
        with open(logs[w] + ".json") as f:
            res = json.load(f)
        if rc != 0 or res["rc"] != 0 or res["cuda_initialized"]:
            failures.append(f"daemon {w} ({logs[w]}): rc {rc}, {res}")

    def spec_env(w: int) -> dict:
        (path,) = glob.glob(os.path.join(work, f"w{w}", "cdi", "*.json"))
        return dict(e.split("=", 1) for e in cdi.load(path).container_edits.env)

    def status(w: int) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", PKG, "status", "--json", *flags[w]],
            env=_daemon_env(), cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def state_file(w: int) -> tuple:
        path = os.path.join(work, f"w{w}", "state", STATE_FILE)
        with open(path, "rb") as f:
            return f.read(), os.stat(path).st_mtime_ns

    guests = []
    try:
        t0 = time.perf_counter()
        for w in (0, 1):
            start(w, 0)
        for w in (0, 1):
            if not kubelets[w].wait_registrations(1, 60):
                raise AssertionError(f"daemon {w} did not register")
        row["start_s"] = round(time.perf_counter() - t0, 3)
        envs = [spec_env(w) for w in (0, 1)]
        row["spec_env"] = envs
        hostnames = ",".join(MULTIHOST_HOSTS)
        if ([e.get(C.ENV_WORKER_HOSTNAMES) for e in envs] != [hostnames] * 2
                or [e.get(C.ENV_WORKER_ID) for e in envs] != ["0", "1"]):
            failures.append(f"the specs' identities: {envs}")
        allocs = []
        for w in (0, 1):
            reg = kubelets[w].registrations[0]
            sock = os.path.join(kubelets[w].socket_dir, reg.endpoint)
            with grpc.insecure_channel(f"unix://{sock}") as ch:
                resp = glue.DevicePluginStub(ch).Allocate(pb.AllocateRequest(
                    container_requests=[pb.ContainerAllocateRequest(
                        device_ids=[index])]))
            allocs.append(dict(resp.container_responses[0].envs))
            kubelets[w].grant(f"multihost-w{w}", reg.resource_name, [index])
        row["allocate_env"] = allocs
        row["status"] = []
        before = [state_file(w) for w in (0, 1)]
        t0 = time.perf_counter()
        runs = [status(w) for w in (0, 1)]  # both at once: each a process
        for w, run in enumerate(runs):
            out, err = run.communicate(timeout=120)
            if run.returncode != 0:
                raise AssertionError(f"status {w}: rc {run.returncode}\n{err}")
            rep = json.loads(out)
            got = dict(ms=round((time.perf_counter() - t0) * 1e3, 3),
                       worker_id=rep["gpu"]["worker_id"],
                       worker_hostnames=rep["gpu"]["worker_hostnames"],
                       pod_assignments=rep.get("pod_assignments"),
                       error=rep.get("pod_assignments_error"))
            row["status"].append(got)
            want = [{"pod": f"multihost-w{w}", "namespace": "default",
                     "container": "guest", "resource": C.DEFAULT_KIND,
                     "device_ids": [index]}]
            if (got["pod_assignments"] != want or got["worker_id"] != w
                    or got["worker_hostnames"] != list(MULTIHOST_HOSTS)):
                failures.append(f"status {w}: {got}")
            if state_file(w) != before[w]:
                failures.append(f"status {w} wrote the state file")
        # A metadata outage across a restart: worker 1 keeps its identity.
        stop(1)
        for name in os.listdir(md):
            os.remove(os.path.join(md, name))
        t0 = time.perf_counter()
        start(1, 1)
        if not kubelets[1].wait_registrations(2, 60):
            raise AssertionError("daemon 1 did not register after its restart")
        row["restart_s"] = round(time.perf_counter() - t0, 3)
        env1 = spec_env(1)
        with open(logs[1] + ".log") as f:
            lines = [json.loads(x) for x in f if x.startswith("{")]
        said = [x["msg"] for x in lines if x.get("logger") == "katatpu.multihost"]
        row["restart"] = dict(worker_id=env1.get(C.ENV_WORKER_ID),
                              worker_hostnames=env1.get(C.ENV_WORKER_HOSTNAMES),
                              resolver_log=said)
        if (env1.get(C.ENV_WORKER_ID) != "1"
                or env1.get(C.ENV_WORKER_HOSTNAMES) != hostnames
                or not any("reusing persisted worker id 1" in m for m in said)):
            failures.append(f"worker 1 after the outage: {row['restart']}")
        # The guests: each with its spec's env and its allocation's.
        with socket.socket() as s:
            s.bind((MULTIHOST_HOSTS[0], 0))
            port = s.getsockname()[1]
        lo = any(name == "lo" for _, name in socket.if_nameindex())
        for w in (0, 1):
            env = {**_daemon_env(), **envs[w], **allocs[w]}
            if lo:  # gloo's pair connections over loopback, as its store's
                env["GLOO_SOCKET_IFNAME"] = "lo"
            guests.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--multihost-guest", str(port)], env=env, cwd=HERE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        rows = []
        for w, g in enumerate(guests):
            out, err = g.communicate(timeout=MULTIHOST_TIMEOUT_S)
            got = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
            guest = next((x for x in got if x.get("phase") == "multihost_guest"),
                         None)
            if g.returncode != 0 or guest is None:
                raise AssertionError(f"multihost: guest {w} rc {g.returncode}\n"
                                     f"{out[-3000:]}\n{err[-3000:]}")
            del guest["phase"]
            rows.append(guest)
        row["guests"] = rows
        for w, guest in enumerate(rows):
            d = guest["distributed"]
            if (d["process_id"] != w or d["num_processes"] != 2
                    or not d["initialized"] or not guest["strides_cover"]):
                failures.append(f"guest {w}: {d}, cover {guest['strides_cover']}")
        if sum(g["stride_rows"] for g in rows) != MULTIHOST_BATCH * MULTIHOST_STEPS:
            failures.append("the strides' rows do not add up to the global batches")
    finally:
        for g in guests:
            if g.poll() is None:
                g.kill()
                g.wait()
        for w, p in procs.items():
            if p.poll() is None:
                stop(w)
        for k in kubelets:
            k.stop()
    row["cuda_initialized"] = torch.cuda.is_initialized()
    if row["cuda_initialized"]:
        failures.append("the daemons' host process initialized CUDA")
    if failures:
        raise AssertionError("multihost: " + "; ".join(failures))
    return row


def multihost_guest(port: int) -> dict:  # torchguard: allow(TL004) the timed rendezvous runs over gloo on the CPU: nothing on the card
    """A guest of configuration 26, started with its spec's and its
    allocation's env: ``initialize_from_env(device="cpu")``, a gloo
    rendezvous at worker 0's address, then ``make_loader``'s stride of
    :data:`MULTIHOST_STEPS` global batches (the world size and rank from
    the group), gathered over the group and held against the batches of a
    one-process loader. Worker 0 then serves :data:`MULTIHOST_MODEL` (all
    layers, int8 KV from the env, 8 lanes, :data:`MULTIHOST_REQUESTS`
    requests) through :func:`run_requests` (the launch rule) and
    ``graph_check``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.guest.distributed import initialize_from_env
    from kata_xpu_device_plugin_tpu_torch.parallel import TokenBatchLoader
    from kata_xpu_device_plugin_tpu_torch.parallel.loader import make_loader

    t0 = time.perf_counter()
    summary = initialize_from_env(port=port, device="cpu")
    row = {"distributed": summary,
           "rendezvous_s": round(time.perf_counter() - t0, 3)}
    rank = dist.get_rank()
    window = MULTIHOST_SEQ + 1
    stream = np.random.default_rng(0).integers(
        0, 32128, 4 * MULTIHOST_BATCH * window).astype(np.int32)
    loader = make_loader(stream, MULTIHOST_BATCH, MULTIHOST_SEQ)
    whole = TokenBatchLoader(stream, MULTIHOST_BATCH, MULTIHOST_SEQ)
    mine = [next(loader) for _ in range(MULTIHOST_STEPS)]
    strides = [None] * dist.get_world_size()
    dist.all_gather_object(strides, mine)
    cover = True
    for step in range(MULTIHOST_STEPS):
        batch = next(whole)
        merged = np.empty_like(batch)
        for r, s in enumerate(strides):
            merged[r::len(strides)] = s[step]
        cover &= bool(np.array_equal(merged, batch))
    row.update(host_count=loader.host_count, host_index=loader.host_index,
               stride_rows=sum(len(b) for b in mine), strides_cover=cover,
               cursor=loader.state_dict(), nccl=NCCL_NOTE)
    dist.destroy_process_group()
    if rank != 0:
        return row
    params, cfg = gemma_setup(model=MULTIHOST_MODEL)
    kw = dict(max_batch=MULTIHOST_REQUESTS, **SERVE_KW)
    srv = GenerationServer(params, cfg, **kw)
    prompts, budgets, lens = phase_requests(MULTIHOST_REQUESTS, cfg.vocab_size,
                                            seed=11)
    _, wall, launches, stats = run_requests(srv, prompts, budgets)
    if stats["kv_quant"] != "int8" or stats["decode_backend"] != "cuda_paged":
        raise AssertionError(f"multihost guest: {stats['kv_quant']} KV, "
                             f"{stats['decode_backend']} decode")
    row["serve"] = dict(model=MULTIHOST_MODEL, n_layers=cfg.n_layers,
                        vocab=cfg.vocab_size, kv_quant=stats["kv_quant"],
                        **serve_row(stats, wall, budgets, lens, launches))
    del srv
    torch.cuda.empty_cache()
    row["graph_check"] = graph_check(params, cfg, kw)
    if not row["graph_check"]["lanes"]:
        raise AssertionError("multihost guest: graph_check ran no live lane")
    return row


def phase_multihost(smi: str) -> dict:
    """Configuration 26 (PERF.md). This process holds a CUDA context, so the
    daemons' side runs in a fresh one (``chip_smoke.py --multihost-daemons``,
    :func:`multihost_daemons`). Returns worker 0's guest's serving
    launches."""
    work = host_work_dir()
    try:
        res = subprocess.run(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--multihost-daemons", work],
            capture_output=True, text=True, cwd=HERE,
            timeout=MULTIHOST_TIMEOUT_S + 240)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    row = next((x for x in lines if x.get("phase") == "multihost_daemons"), None)
    if res.returncode != 0 or row is None:
        raise AssertionError(f"multihost: rc {res.returncode}\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    del row["phase"]
    emit("multihost", nvidia_smi=smi, **row)
    return row["guests"][0]["serve"]["launches"]


# ----- the bench configs at head_dim 64 and the quality ladder (config 27) --

# Configuration 27 (PERF.md): llama3_train_bench, all 12 layers, at the JAX
# bench's train shape (bench.py measure_train: B=16, S=1024, remat on).
BENCH_TRAIN = dict(B=16, seq_len=1023, steps=4, remat=True)
BENCH_D64 = ("llama3_train_bench B16 S1024 D64", 16, 1024, 16, 8, 64)
EVAL_ARGS = ["--config", "llama3_train_bench", "--dtype", "bfloat16"]
# The paged decode kernel at llama3_train_bench's heads (B=4, H=16, KV=8,
# D=64): at the tile the ladder's generate takes (its 32 + 64 positions pad
# to a slotted arena of 128, one 128-row block a lane: dense_decode_tile),
# then over permuted 16-row blocks of a 2048-position view with a dead lane.
BENCH_DECODE = ((128, 128, False), (16, 2048, True))  # (tile, view, dead)


def kv_witness(ladder) -> dict:
    """A second witness for the ladder's int8-KV rung, on its weights,
    prompts and steps (``ladder.setup`` with :data:`EVAL_ARGS`): the
    kernels' bf16 and int8 runs again (their ``kv_agree`` must equal the
    rung's: the kernels are deterministic), the plain attention's own pair
    (prefill and decode through ``reference_attention``), each kernel run
    against the plain run over the same cache, and where the int8 runs
    first part, the plain path's top-2 logit margin, beside the scale of
    the logits and of their drift between the flash and the plain forward
    on the ladder's tokens."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.models.transformer import forward
    from kata_xpu_device_plugin_tpu_torch.ops.attention import reference_attention

    args = ladder.parse_args(EVAL_ARGS)
    cfg, params, tokens = ladder.setup(args, torch.device("cuda"))
    toks = torch.as_tensor(tokens, device="cuda")
    with torch.no_grad():
        flash_lg, plain_lg = (
            forward(params, toks[:, :-1], cfg, attn_fn=fn).float()
            for fn in (None, reference_attention))
    drift = (flash_lg - plain_lg).abs()
    kern = ladder.kv_decodes(params, cfg, toks, args.decode_steps)
    plain = ladder.kv_decodes(params, cfg, toks, args.decode_steps,
                              attn_fn=reference_attention)
    prompts = tokens[:, :ladder.kv_prompt_len(tokens.shape[1])]
    return {"logit_rms": float(plain_lg.pow(2).mean().sqrt()),
            "flash_vs_plain_max_drift": float(drift.max()),
            "flash_vs_plain_mean_drift": float(drift.mean()),
            "kernel": ladder.agreement(*kern, "kv_agree"),
            "plain": ladder.agreement(*plain, "kv_agree"),
            "bf16_kernel_vs_plain": ladder.agreement(kern[0], plain[0], "agree"),
            "int8_kernel_vs_plain": ladder.agreement(kern[1], plain[1], "agree"),
            "int8_first_parting": first_difference_margin(
                params, cfg, prompts, kern[1], plain[1])}


def load_script(name: str):
    """``scripts/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_bench_configs(profile: bool = False) -> tuple:
    """``fit`` of ``llama3_train_bench`` (the loss must fall, the launches
    exact), its three flash kernels at D = 64 alone against their plain
    versions within ``kernel_tolerance``, timed beside SDPA and the bound
    (:func:`flash_case`, :func:`bwd_case`), then
    ``scripts/torch_eval_quality.py`` with :data:`EVAL_ARGS` in this
    process, its rows printed and its launches counted. Returns the
    phase's launches and the cases by kernel."""
    import io

    import torch

    launches = phase_train("llama3_train_bench", n_layers=12, profile=profile,
                           phase="bench_train", **BENCH_TRAIN)
    f = flash_case(*BENCH_D64, lse=True, timed=True)
    b = bwd_case(*BENCH_D64, timed=True)
    dec = [decode_case(f"llama3_train_bench {'int8' if q else 'bf16'} bs{bs} "
                       f"L{view}", 4, 16, 8, 64, bs, q, max_len=view,
                       timed=not dead, dead=dead)
           for bs, view, dead in BENCH_DECODE for q in (True, False)]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "max_err_over_bound")
    emit("bench_d64", case=BENCH_D64[0], shape=list(BENCH_D64[1:]),
         **{f"fwd_{k}": f[k] for k in keys},
         **{f"{g}_{k}": b[g][k] for g in ("dq", "dkv") for k in keys},
         decode=[{k: c.get(k) for k in ("case",) + keys} for c in dec])
    ladder = load_script("torch_eval_quality")
    kernels = counted_kernels()
    for fn in kernels.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ladder.main(EVAL_ARGS)
    torch.cuda.synchronize()
    seconds = round(time.perf_counter() - t0, 2)
    rows = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    counted = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    emit("eval_quality", args=EVAL_ARGS, seconds=seconds, rows=rows,
         launches=counted)
    if rc != 0 or [r["variant"] for r in rows] != ["baseline", "int8", "w8a8",
                                                   "int8_kv"]:
        raise AssertionError(f"eval_quality: rc {rc}, {rows}")
    if not all(math.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float)):
        raise AssertionError(f"eval_quality: a rung is not finite: {rows}")
    if set(counted) != {"flash_fwd", "paged_decode"}:
        raise AssertionError(f"eval_quality must launch the flash and paged "
                             f"kernels and no other: {counted}")
    for k, n in counted.items():
        launches[k] = launches.get(k, 0) + n
    witness = kv_witness(ladder)
    emit("eval_quality_kv_witness", **witness)
    if witness["kernel"]["kv_agree"] != rows[3]["kv_agree"]:
        raise AssertionError(f"eval_quality: the kernels' int8-KV rung gave "
                             f"{rows[3]} and then {witness['kernel']}")
    return launches, {"flash_fwd": [f], "flash_bwd_dq": [b["dq"]],
                      "flash_bwd_dkv": [b["dkv"]], "paged_decode": dec}


# ----- the guest journey at llama3_train_bench's width (configuration 29) --

# scripts/torch_train_demo.py's journey on the card: its bench size, every
# shard of its data x fsdp x model mesh on the one device.
JOURNEY = "llama3_train_bench"


@contextlib.contextmanager
def timing_checkpoints(marks: list):
    """Each ``TrainCheckpointer.save`` and ``restore`` while open appended
    to ``marks`` as ``(name, seconds)``, synchronized."""
    import torch

    from kata_xpu_device_plugin_tpu_torch.parallel import TrainCheckpointer

    real = {n: getattr(TrainCheckpointer, n) for n in ("save", "restore")}

    def timed(name):
        def call(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](self, *args, **kw)
            torch.cuda.synchronize()
            marks.append((name, round(time.perf_counter() - t0, 3)))
            return out
        return call

    for n in real:
        setattr(TrainCheckpointer, n, timed(n))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(TrainCheckpointer, n, fn)


def phase_journey(smi: str, seed: int = 0) -> tuple:
    """Configuration 29 (PERF.md): ``scripts/torch_train_demo.py``'s stages
    at ``llama3_train_bench``'s full width and depth (12 layers, d_model
    1024, 16/8 heads of 64, d_ff 4096, vocab 32768), bf16 compute.
    Pretrain over data 2 x fsdp 2 x model 2 on the one card, B=16, S=1024,
    on the script's synthetic corpus, a checkpoint every 2 steps,
    preempted at 4 and resumed to 8, beside an uninterrupted 8-step run:
    its losses, params and moments bit-equal to the resumed run's, the
    loss falling. LoRA rank 8 on wq/wk/wv/wo over the resumed params, 5
    steps on ``[8, 1024]`` tokens, the loss falling, the base bit-equal
    before and after. Merge, fuse, int8. Then 8 prompts of 64-1000 tokens,
    64 new tokens each, ``max_batch=4``, ``max_len=2048``, through the
    speculative server (k=3, int8 KV) and the reference, a paged int8-KV
    server over the same tree: every budget delivered, the slots, queue
    and pool empty at the end, each speculative request's first parting
    from the reference a bf16 flip (:func:`token_partings`). Launches
    reset before and read after each stage: flash forward, dq and dk/dv
    steps x 12 layers x 8 local blocks for the mesh steps, 5 x 12 for the
    LoRA steps; the reference server's paged decode rounds x chunk x 12
    (:func:`run_requests`). The flash kernels at a mesh block's training
    shape and the paged decode kernel at the serving shape against their
    plain versions, timed. Returns the phase's launches and the cases by
    kernel."""
    import numpy as np
    import torch

    from kata_xpu_device_plugin_tpu_torch import models
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.ops.lora import DEFAULT_TARGETS
    from kata_xpu_device_plugin_tpu_torch.parallel import build_mesh
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves, local

    demo = load_script("torch_train_demo")
    size, cfg = demo.SIZES[JOURNEY], getattr(models, JOURNEY)()
    L = cfg.n_layers
    mesh = build_mesh(demo.MESH)
    blocks = math.prod(demo.MESH.values())  # batch over data x fsdp, heads over model
    B, S = size["batch"], size["seq_len"] + 1
    corpus = demo.corpus_for(cfg, JOURNEY, seed)
    train = dict(batch=size["batch"], seq_len=size["seq_len"], seed=seed)
    stages, marks, failures = {}, [], []

    def stage(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        stages[name] = round(time.perf_counter() - t0, 3)
        return out

    # 1-2. Pretrain, preempted at 4, resumed to 8; then the same 8 steps
    # uninterrupted, the run the resumed one must replay.
    ckpt_dir = tempfile.mkdtemp(prefix="journey_ckpt_")
    reset_counts()
    try:
        with timing_checkpoints(marks):
            _, losses_a = stage("pretrain", demo.pretrain, cfg, mesh, corpus,
                                ckpt_dir, size["preempt_at"],
                                size["ckpt_every"], **train)
            state, losses_b = stage("resume", demo.resume, cfg, mesh, corpus,
                                    ckpt_dir, size["steps"],
                                    size["ckpt_every"], **train)
        ckpt_bytes = os.path.getsize(
            os.path.join(ckpt_dir, f"step_{size['steps']}.pt"))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    on_step, stamps = step_timer()
    whole, losses_w = stage("uninterrupted", demo.pretrain, cfg, mesh, corpus,
                            None, size["steps"], 0, on_step=on_step, **train)
    train_counts = read_counts()
    trees = [(state["params"], whole["params"]),
             (state["opt"]["mu"], whole["opt"]["mu"]),
             (state["opt"]["nu"], whole["opt"]["nu"])]
    resume_equal = losses_a + losses_b == losses_w and all(
        torch.equal(a, b) for x, y in trees for a, b in zip(leaves(x), leaves(y)))
    del whole, trees
    torch.cuda.empty_cache()
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    p50 = float(np.median(step_s))
    train_steps = 2 * size["steps"]

    # 3. LoRA over the resumed params (the mesh's pieces gathered whole).
    before = {k: local(state["params"]["layers"][k]).clone()
              for k in DEFAULT_TARGETS}
    toks = demo.lora_tokens(cfg, size["lora_tokens"],
                            torch.Generator(device="cuda").manual_seed(seed + 2))
    reset_counts()
    lora_on, lora_stamps = step_timer()
    lstate, lora_losses = stage(
        "lora", demo.lora_finetune, state["params"], cfg,
        torch.Generator(device="cuda").manual_seed(seed + 1),
        rank=size["lora_rank"], steps=size["lora_steps"], tokens=toks,
        lr=size["lora_lr"], on_step=lora_on)
    lora_counts = read_counts()
    del state
    frozen = all(torch.equal(lstate["params"]["layers"][k].base, w)
                 for k, w in before.items())
    lora_p50 = float(np.median([b - a for a, b in zip(lora_stamps,
                                                      lora_stamps[1:])]))
    del before

    # 4. Merge, fuse, int8.
    served = stage("prepare", demo.prepare_for_serving, lstate["params"])
    del lstate
    torch.cuda.empty_cache()
    held_bytes, bf16_bytes = tree_bytes(served)

    # 5. Serve: the speculative server, then the reference over the same
    # tree (a paged int8-KV server, the paged decode kernel every step).
    prompts = demo.prompts_for(corpus, JOURNEY, seed)
    budgets = np.full(len(prompts), size["new_tokens"])
    lens = [len(p) for p in prompts]
    serving = {}
    spec = GenerationServer(served, cfg, **size["server"])
    outs, wall, spec_launches, st = stage("serve_spec", spec_serve, spec,
                                          prompts, budgets, serving)
    spec_row = dict(tok_s=round(int(budgets.sum()) / wall, 2),
                    wall_s=round(wall, 4), rounds=st["rounds"],
                    draft_acceptance=st["draft_acceptance"],
                    tokens_per_round=round((st["tokens_emitted"] - st["prefills"])
                                           / max(st["rounds"], 1), 3),
                    ttft_p50_s=st["ttft_s"]["p50"],
                    itl_p50_s=st["decode_token_s"]["p50"],
                    decode_backend=st["decode_backend"], launches=spec_launches)
    ends = {"spec": spec.stats()}
    del spec
    kw = {k: v for k, v in size["server"].items()
          if k not in ("speculative_k", "spec_opt_in")}
    ref = GenerationServer(served, cfg, kv_pool_tokens=kw["max_batch"] * kw["max_len"],
                           kv_block_size=16, **kw)
    ref_outs, ref_row, ref_launches = stage("serve_reference", serve_launch_row,
                                            ref, prompts, budgets, lens)
    ends["reference"] = ref.stats()
    del ref
    add_launches(serving, ref_launches)
    for name, end in ends.items():
        left = {k: end[k] for k in ("slots_busy", "queued", "kv_blocks_in_use",
                                    "preempted_waiting")}
        if any(left.values()):
            failures.append(f"{name} server ends holding {left}")
    partings = token_partings(served, cfg, prompts, outs, ref_outs, True)
    if not partings["all_flips"]:
        failures.append(f"the speculative server parts from the reference: "
                        f"{partings}")
    del served
    torch.cuda.empty_cache()

    # The kernels at the journey's shapes: a mesh block of the train step
    # (the batch over data x fsdp, the heads over model) and a decode step
    # of the reference server (4 lanes over 16-row blocks of 2048 positions).
    name = f"journey {JOURNEY} mesh block"
    m = demo.MESH
    shape = (B // (m["data"] * m["fsdp"]), S, cfg.n_heads // m["model"],
             cfg.n_kv_heads // m["model"], cfg.head_dim)
    f = flash_case(name, *shape, lse=True, timed=True)
    b = bwd_case(name, *shape, timed=True)
    dec = decode_case(f"journey {JOURNEY} int8 bs16 L{kw['max_len']}",
                      kw["max_batch"], cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, 16, True, max_len=kw["max_len"], timed=True)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "max_err_over_bound")

    want_train = train_steps * L * blocks
    want_lora = size["lora_steps"] * L
    launches = {k: train_counts[k] + lora_counts[k] for k in FLASH_KERNELS}
    add_launches(launches, serving)
    ck = dict(marks)
    emit("journey", model=JOURNEY, nvidia_smi=smi, mesh=demo.MESH,
         n_layers=L, B=B, S=S, stage_s=stages,
         losses_interrupted=losses_a, losses_resumed=losses_b,
         losses_uninterrupted=losses_w, resume_bit_equal=resume_equal,
         checkpoint_bytes=ckpt_bytes,
         checkpoint_write_s=[s for n, s in marks if n == "save"],
         checkpoint_restore_s=ck.get("restore"),
         step_s=step_s, step_p50_s=p50, tokens_per_s=B * S / p50,
         lora_rank=size["lora_rank"], lora_losses=lora_losses,
         lora_step_p50_s=lora_p50, base_frozen=frozen,
         served_tree_bytes=held_bytes, bf16_tree_bytes=bf16_bytes,
         requests=len(prompts), prompt_lens=lens, budgets=budgets.tolist(),
         spec=spec_row,
         reference={k: ref_row[k] for k in SIDE_KEYS},
         token_match=token_match(outs, ref_outs, budgets), partings=partings,
         kernels={"flash_fwd": {k: f[k] for k in keys},
                  **{g: {k: b[g][k] for k in keys} for g in ("dq", "dkv")},
                  "paged_decode": {k: dec.get(k) for k in keys}},
         launches={"train": train_counts, "lora": lora_counts,
                   "serving": serving},
         launches_want={"train": want_train, "lora": want_lora})
    for name, losses in (("pretrain", losses_w), ("lora", lora_losses)):
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            failures.append(f"{name} loss not finite and falling: {losses}")
    if not resume_equal:
        failures.append(f"the resumed run {losses_a + losses_b} is not the "
                        f"uninterrupted run {losses_w} bit for bit")
    if not frozen:
        failures.append("a LoRA step moved the base weights")
    if failures:
        raise AssertionError("journey: " + "; ".join(failures))
    expect_counts("journey train", train_counts,
                  {k: want_train for k in FLASH_KERNELS})
    expect_counts("journey lora", lora_counts,
                  {k: want_lora for k in FLASH_KERNELS})
    if spec_launches.get("paged_decode") or not spec_launches.get("flash_fwd"):
        raise AssertionError(f"journey: the speculative server launches "
                             f"{spec_launches}")
    if serving["flash_fwd"] % L:
        raise AssertionError(f"journey: an admission left the flash kernel: "
                             f"{serving}")
    return launches, {"flash_fwd": [f], "flash_bwd_dq": [b["dq"]],
                      "flash_bwd_dkv": [b["dkv"]], "paged_decode": [dec]}


def tree_bytes(params: dict) -> tuple:
    """A decoder tree's bytes as held, and the same weights' in bf16 (an
    int8 weight's payload at 2 bytes, its scales dropped)."""
    held = bf16 = 0
    for v in [*(params[k] for k in params if k != "layers"),
              *params["layers"].values()]:
        ts = list(v) if isinstance(v, tuple) else [v]
        held += sum(t.numel() * t.element_size() for t in ts)
        bf16 += 2 * ts[0].numel()
    return held, bf16


def main(argv: list[str]) -> int:
    if not os.path.isdir(os.path.join(HERE, PKG, "csrc")):
        print(f"chip_smoke: {PKG} not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if argv[:1] == ["--host-daemon"]:  # phase_host's daemon side: no CUDA
        emit("host_daemon", **host_daemon(int(argv[1]), argv[2]))
        return 0
    if argv[:1] == ["--multihost-daemons"]:  # phase_multihost's host side
        emit("multihost_daemons", **multihost_daemons(argv[1]))
        return 0
    if argv[:1] == ["--multihost-daemon"]:  # one daemon: the CLI, then a report
        from kata_xpu_device_plugin_tpu_torch.__main__ import main as daemon_main

        rc = daemon_main(argv[2:])
        import torch

        with open(argv[1], "w") as f:
            json.dump({"rc": rc, "cuda_initialized": torch.cuda.is_initialized()}, f)
        return rc
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[:1] == ["--host-guest"]:  # phase_host's guest, under its env
        emit("host_guest", **host_guest())
        return 0
    if argv[:1] == ["--multihost-guest"]:  # a guest of phase_multihost
        emit("multihost_guest", **multihost_guest(int(argv[1])))
        return 0
    profile = "--profile" in argv  # adds profiled decode rounds and a train step
    seconds = {}

    def timed_phase(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 2)
        return out

    smi = phase_device()
    timed_phase("build", phase_build)
    checks = timed_phase("check", phase_checks)
    extra = checks.pop("paged_decode_extra")
    dense_extra = checks.pop("dense_decode_extra")
    bwd_extra = checks.pop("flash_bwd_extra")
    fwd_extra = checks.pop("flash_fwd_extra")
    block_extra = checks.pop("flash_block_extra")
    params, cfg = timed_phase("serve_setup", gemma_setup)
    launches = {"serve": timed_phase("serve", phase_serve, params, cfg,
                                     profile=profile)}
    launches["paged"] = timed_phase("paged", phase_paged, params, cfg,
                                    profile=profile)
    launches["telemetry"] = timed_phase("telemetry", phase_telemetry, params,
                                        cfg, smi)
    launches["persistent"] = timed_phase("persistent", phase_persistent,
                                         params, cfg)
    launches["sched"] = timed_phase("sched", phase_sched, params, cfg)
    launches["prefix"] = timed_phase("prefix", phase_prefix, params, cfg)
    launches["guards"] = timed_phase("guards", phase_guards, params, cfg, smi)
    launches["tp"], checks["paged_decode_shard"] = timed_phase(
        "tp", phase_tp, params, cfg)
    launches["resilience"] = timed_phase("resilience", phase_resilience,
                                         params, cfg, smi)
    launches["generate"] = timed_phase("generate", phase_generate, params, cfg)
    launches["spec"] = timed_phase("spec", phase_spec, params, cfg)
    launches["w8a8"] = timed_phase("w8a8", phase_w8a8, params, cfg)
    launches["kv_gate"] = timed_phase("kv_gate", phase_kv_gate, params, cfg)
    del params
    torch.cuda.empty_cache()
    launches["lora"] = timed_phase("lora", phase_lora)
    launches["moe"] = timed_phase("moe", phase_moe, profile=profile)
    torch.cuda.empty_cache()
    launches["fsdp_tp"] = timed_phase("fsdp_tp", phase_fsdp_tp, profile=profile)
    torch.cuda.empty_cache()
    for name, fn in (("pipeline", phase_pipeline), ("ep_moe", phase_ep_moe),
                     ("lora_mesh", phase_lora_mesh)):
        launches[name] = timed_phase(name, fn)
        torch.cuda.empty_cache()
    for name, cases in timed_phase("local_blocks", phase_local_blocks).items():
        checks[name] += cases
    launches["serve_mesh"] = timed_phase("serve_mesh", phase_serve_mesh,
                                         profile=profile)
    torch.cuda.empty_cache()
    launches["moe_tp"] = timed_phase("moe_tp", phase_moe_tp)
    torch.cuda.empty_cache()
    timed_phase("convert", phase_convert)
    torch.cuda.empty_cache()
    timed_phase("probe", phase_probe)
    launches["host"] = timed_phase("host", phase_host, smi)
    launches["multihost"] = timed_phase("multihost", phase_multihost, smi)
    for name, cases in timed_phase("mesh_shards", phase_mesh_shards).items():
        checks[name] += cases
    for name, n in timed_phase("families", phase_families,
                               profile=profile).items():
        launches[f"family_{name}"] = n
    launches["generate_qwen2"] = timed_phase("generate_qwen2",
                                             phase_generate_qwen2)
    torch.cuda.empty_cache()
    launches["train"] = timed_phase("train", phase_train, profile=profile)
    timed_phase("train_crosscheck", train_crosscheck)
    torch.cuda.empty_cache()
    launches["train_gemma"] = timed_phase(
        "train_gemma", phase_train, model="gemma_2b", n_layers=6, steps=4,
        profile=profile, phase="train_gemma")
    timed_phase("train_gemma_crosscheck", train_crosscheck, model="gemma_2b",
                phase="train_gemma_crosscheck")
    torch.cuda.empty_cache()
    launches["seq"] = timed_phase("seq", phase_seq, profile=profile)
    torch.cuda.empty_cache()
    timed_phase("seq_crosscheck", seq_crosscheck)
    torch.cuda.empty_cache()
    launches["seq_gemma2"] = timed_phase(
        "seq_gemma2", phase_seq, model="gemma2_2b", n_layers=4, steps=3,
        phase="seq_gemma2")
    torch.cuda.empty_cache()
    launches["bench_configs"], bench_cases = timed_phase(
        "bench_configs", phase_bench_configs, profile=profile)
    for name, cases in bench_cases.items():
        checks[name] += cases
    torch.cuda.empty_cache()
    launches["journey"], journey_cases = timed_phase("journey", phase_journey,
                                                     smi)
    for name, cases in journey_cases.items():
        checks[name] += cases
    emit("seconds", **seconds, total=round(sum(seconds.values()), 2))
    src = f"{PKG}/csrc"
    jax_flash = "kata_xpu_device_plugin_tpu/ops/flash.py"
    meta = {
        "flash_fwd": dict(route="cuda", source=f"{src}/flash_fwd.cu",
                          replaces=f"{jax_flash}:70", extra=fwd_extra),
        "paged_decode": dict(route="cuda", source=f"{src}/paged_decode.cu",
                             replaces="kata_xpu_device_plugin_tpu/ops/decode_attn.py:213",
                             extra=extra),
        # The shard-local form (K2) of the same TPU kernel: shard_blocks,
        # shard_lo and return_stats (decode_attn.py:222-269, :406-418).
        "paged_decode_shard": dict(
            route="cuda", source=f"{src}/paged_decode.cu",
            replaces="kata_xpu_device_plugin_tpu/ops/decode_attn.py:213",
            extra={k: next(c for c in checks["paged_decode_shard"] if "ms" in c)[k]
                   for k in ("all_shards_and_merge_ms", "unsharded_ms",
                             "owned_keys", "live_owned_keys", "live_bound_ms",
                             "all_keys")}),
        "dense_decode": dict(route="cuda", source=f"{src}/dense_decode.cu",
                             replaces="kata_xpu_device_plugin_tpu/ops/decode_attn.py:74",
                             extra=dense_extra),
        "flash_bwd_dq": dict(route="cuda", source=f"{src}/flash_bwd.cu",
                             replaces=f"{jax_flash}:219", extra=bwd_extra),
        "flash_bwd_dkv": dict(route="cuda", source=f"{src}/flash_bwd.cu",
                              replaces=f"{jax_flash}:283"),
        # The ring block API's forms (K1) of the same three TPU kernels:
        # offsets, and the lse cotangent in the backward's bracket.
        "flash_fwd_block": dict(route="cuda", source=f"{src}/flash_fwd.cu",
                                replaces=f"{jax_flash}:551",
                                extra={k: v for k, v in block_extra.items()
                                       if "_fwd_" in k}),
        "flash_bwd_dq_block": dict(route="cuda", source=f"{src}/flash_bwd.cu",
                                   replaces=f"{jax_flash}:551",
                                   extra={k: v for k, v in block_extra.items()
                                          if "_dq_" in k}),
        "flash_bwd_dkv_block": dict(route="cuda", source=f"{src}/flash_bwd.cu",
                                    replaces=f"{jax_flash}:551",
                                    extra={k: v for k, v in block_extra.items()
                                           if "_dkv_" in k}),
    }
    kernels = []
    for name, cases in checks.items():
        timed = next(c for c in cases if "ms" in c)
        by_path = {p: n[name] for p, n in launches.items() if name in n}
        kernels.append({
            "name": name, **meta[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_err_over_bound": max(c["max_err_over_bound"] for c in cases),
            "ms": timed["ms"], "call_ms": timed.get("call_ms"),
            "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"], "timed_case": timed["case"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
