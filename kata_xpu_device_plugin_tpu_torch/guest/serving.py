"""Continuous-batching generation server (counterpart of
``GenerationServer`` in ``kata_xpu_device_plugin_tpu/guest/serving.py``).

This slice ports the server's default mode: one slotted KV arena
``[L, max_batch, max_len, KV, D]`` (int8 by default), greedy decoding in
lock-step rounds of ``chunk`` steps, and batched admission through
``prefill_batch``. On CUDA every prefill runs the flash kernel and every
decode step the paged decode kernel over a zero-copy pool view of the
arena (:func:`..ops.attention.make_decode_attn_fn`); the plain versions
run there only when the caller asks for ``decode_attn="reference"``, and
anything the kernels cannot take raises. On the CPU the wrappers run
their plain versions. Greedy outputs per request equal the JAX server's
on the same weights.

Arguments of the JAX server that select modes this slice does not port
(the paged pool, tensor parallelism, speculative decoding, ring caches,
the prefix cache, sampling, chunked scheduling, multi-step and persistent
decode, crash recovery, and the overlapped round loop) raise
``NotImplementedError`` when set.
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device
from ..constants import DEFAULT_KV_QUANT, ENV_DECODE_ATTN, ENV_KV_QUANT
from ..models.transformer import (
    DecoderConfig,
    _decode_scan,
    check_supported,
    init_kv_caches,
    prefill_batch,
)
from ..obs.metrics import Rolling
from ..ops import attention
from ..ops.quant import QTensor
from .scheduler import fifo_batch

BACKEND_PAGED = attention.BACKEND_PAGED
BACKEND_REFERENCE = attention.BACKEND_REFERENCE


def require_flash_buckets(buckets: tuple, head_dim: int) -> None:
    """On CUDA each prompt is padded to a prefill bucket and its prefill
    runs the flash kernel: raise unless there are buckets and the kernel
    takes every one of them."""
    if not buckets:
        raise ValueError(
            "a CUDA server needs prefill_buckets: prompts are padded to them "
            "so that every prefill runs the flash kernel")
    bad = [b for b in buckets
           if not attention.flash_eligible(b, b, head_dim, on_cuda=True)]
    if bad:
        raise ValueError(
            f"prefill_buckets {bad} are not flash-kernel lengths at head_dim "
            f"{head_dim} (need a divisor >= 128 that is a multiple of 32)")


def resolve_kv_quant(kv_quant) -> bool:
    """Explicit argument > ``KATA_TPU_KV_QUANT`` ("int8" | "bf16") > int8.
    A malformed env value degrades to the default."""
    if kv_quant is not None:
        return bool(kv_quant)
    raw = os.environ.get(ENV_KV_QUANT, "").strip().lower()
    if raw not in ("int8", "bf16"):
        raw = DEFAULT_KV_QUANT
    return raw == "int8"


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    t_submit: float = 0.0
    out: list = field(default_factory=list)


def _write_slots(arena, batch_caches, slots: torch.Tensor) -> None:
    """Copy the N rows of one admission prefill (leaves ``[L, N, S, ...]``)
    into arena slots ``slots`` at positions ``0 .. S-1``, in place. Rows
    past S keep an earlier request's values: decode writes position p
    before it attends to it and masks everything past p, so they are never
    read."""
    for a, c in zip(arena, batch_caches):
        pairs = zip(a, c) if isinstance(a, QTensor) else ((a, c),)
        for dst, src in pairs:
            dst[:, slots, : src.shape[2]] = src


def _serve_decode(params, arena, tok, pos, cfg, steps: int,
                  decode_kernel_fn=None):
    """One fixed-``steps`` ragged decode chunk over the arena (in place),
    through ``decode_kernel_fn``, or the plain attention when it is None.
    Returns ``(tokens [B, steps], last [B], pos [B])`` on the device."""
    toks, _caches, last, pos = _decode_scan(
        params, arena, tok, pos, cfg, steps,
        attn_fn=attention.reference_attention, return_state=True,
        decode_kernel_fn=decode_kernel_fn,
    )
    return toks, last, pos


class GenerationServer:
    """Slot-based continuous batching over one decode arena.

    >>> srv = GenerationServer(params, cfg, max_batch=4, max_len=512)
    >>> rid = srv.submit(prompt_tokens, max_new_tokens=64)
    >>> results = srv.run()          # {rid: np.ndarray of generated tokens}

    ``kv_quant=None`` resolves int8 KV unless ``KATA_TPU_KV_QUANT=bf16``.
    ``decode_attn`` picks the decode attention: ``"cuda_paged"`` (the
    kernel; its plain version on the CPU) or ``"reference"`` (the plain
    attention over the arena); None reads ``KATA_TPU_DECODE_ATTN``, then
    chooses the kernel on CUDA and the plain attention on the CPU. A
    kernel that cannot serve the config raises. ``device`` defaults to
    CUDA and must hold ``params``; there every prompt is padded to one of
    ``prefill_buckets``, which must all be flash-kernel lengths."""

    def __init__(self, params: Any, cfg: DecoderConfig, max_batch: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 chunk: int = 8, temperature: float = 0.0,
                 kv_quant: Optional[bool] = None, prefill_buckets: tuple = (),
                 overlap: bool = False, decode_attn: Optional[str] = None,
                 device=None,
                 kv_pool_tokens: Optional[int] = None, tp: Optional[int] = None,
                 speculative_k: int = 0, ring_kv: bool = False,
                 prefix_cache_tokens: Optional[int] = None,
                 sched_policy: Optional[str] = None,
                 decode_steps: Optional[int] = None,
                 persistent: Optional[bool] = None,
                 checkpoint_rounds: Optional[int] = None):
        unported = {
            "kv_pool_tokens (paged pool, ROADMAP Queue 1 item 4)": kv_pool_tokens,
            "tp (tensor parallelism, ROADMAP Queue 1 item 10)": (tp or 1) > 1,
            "speculative_k (ROADMAP Queue 1 item 11)": speculative_k,
            "ring_kv (ROADMAP Queue 1 item 11)": ring_kv,
            "prefix_cache_tokens (ROADMAP Queue 1 item 8)": prefix_cache_tokens,
            "temperature > 0 (sampling, ROADMAP Queue 1 item 11)": temperature,
            "sched_policy='slo_chunked' (ROADMAP Queue 1 item 8)": (
                sched_policy not in (None, "fifo_batch")),
            "decode_steps > 1 (ROADMAP Queue 1 item 7)": (decode_steps or 1) > 1,
            "persistent (ROADMAP Queue 1 item 7)": persistent,
            "checkpoint_rounds (recovery, ROADMAP Queue 1 item 9)": checkpoint_rounds,
            "overlap=True (overlapped rounds, ROADMAP Queue 1 item 5)": overlap,
        }
        for what, value in unported.items():
            if value:
                raise NotImplementedError(f"{what} is not ported yet")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if any(b < 1 or b > max_len for b in prefill_buckets):
            raise ValueError(
                f"prefill_buckets {prefill_buckets} must lie in [1, max_len]")
        check_supported(cfg)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            require_flash_buckets(prefill_buckets, cfg.head_dim)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the server runs on "
                f"{self.device}")
        self.params, self.cfg = params, cfg
        self.max_batch, self.max_len = max_batch, max_len
        self.eos_id, self.chunk = eos_id, chunk
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.arena = init_kv_caches(cfg, max_batch, max_len, device=self.device,
                                    quantized=self.kv_quant)
        self._decode_attn, self._decode_attn_reason = (
            self._resolve_decode_attn(decode_attn))
        self._decode_kernel = None
        if self._decode_attn == BACKEND_PAGED:
            self._decode_kernel = attention.make_decode_attn_fn(
                cfg, arena_len=max_len, device=self.device)
        # Host-side slot state: the request in each slot, its next cache
        # write position, and its last token.
        self._slot_req: list[Optional[_Request]] = [None] * max_batch
        self._pos = np.zeros(max_batch, np.int32)
        self._last = np.zeros(max_batch, np.int32)
        self._queue: deque[_Request] = deque()
        self._results: dict[int, np.ndarray] = {}
        self._failures: dict[int, str] = {}
        self._next_rid = 0
        self._rounds = 0
        self._emitted = 0
        self._prefills = 0
        self._batch_prefills = 0
        self._ttft = Rolling()
        self._tok_lat = Rolling()

    # ----- decode backend --------------------------------------------------

    def _resolve_decode_attn(self, choice: Optional[str]):
        """``(backend, reason)``: explicit argument > env > automatic (the
        kernel on CUDA, the plain attention on the CPU). A malformed env
        value is ignored; the plain attention runs on the card only when
        asked for."""
        if choice is None:
            raw = os.environ.get(ENV_DECODE_ATTN, "").strip()
            choice = raw if raw in attention.DECODE_ATTN_BACKENDS else None
        elif choice not in attention.DECODE_ATTN_BACKENDS:
            raise ValueError(f"unknown decode_attn {choice!r} "
                             f"(have {attention.DECODE_ATTN_BACKENDS})")
        if choice is not None:
            return choice, "forced"
        if self.device.type != "cuda":
            return BACKEND_REFERENCE, "cpu_backend"
        return BACKEND_PAGED, ""

    # ----- public API ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 64) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds arena max_len ({self.max_len})")
        if self.device.type == "cuda" and len(prompt) > self.prefill_buckets[-1]:
            raise ValueError(
                f"prompt ({len(prompt)}) is longer than the largest prefill "
                f"bucket ({self.prefill_buckets[-1]}): on CUDA every prompt "
                "is padded to a bucket the flash kernel takes")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, prompt, max_new_tokens,
                                    t_submit=time.perf_counter()))
        return rid

    def run(self) -> dict[int, np.ndarray]:
        """Drain queue and slots; returns ``{rid: generated tokens}``."""
        while self.step():
            pass
        out, self._results = self._results, {}
        return out

    def failures(self) -> dict[int, str]:
        """Per-request terminal failures. Without crash recovery (not ported)
        an error propagates out of :meth:`run`, so this stays empty."""
        return dict(self._failures)

    def stats(self) -> dict:
        """Cumulative serving counters; keys keep the JAX server's names."""
        return {
            "rounds": self._rounds,
            "prefills": self._prefills,
            "prefill_batches": self._batch_prefills,
            "tokens_emitted": self._emitted,
            "ttft_s": self._ttft.summary(),
            "decode_token_s": self._tok_lat.summary(),
            "arena_bytes": sum(
                t.numel() * t.element_size()
                for c in self.arena
                for t in (c if isinstance(c, QTensor) else (c,))),
            "decode_backend": self._decode_attn,
            "decode_backend_reason": self._decode_attn_reason,
            "kv_quant": "int8" if self.kv_quant else "bf16",
        }

    # ----- admission -------------------------------------------------------

    def _admit(self) -> None:
        """Refill free slots from the queue, FIFO, one ``prefill_batch`` per
        padded-length group. Loops because a request can finish during its
        own prefill (eos or a 1-token budget) and free its slot again."""
        while self._queue:
            free = [b for b in range(self.max_batch) if self._slot_req[b] is None]
            if not free:
                return
            groups = fifo_batch(self._queue, len(free), self.prefill_buckets)
            it = iter(free)
            for pad_len, reqs in groups.items():
                self._fill_slots_batched([next(it) for _ in reqs], reqs, pad_len)

    def _fill_slots_batched(self, slots: list[int], reqs: list,
                            pad_len: int) -> None:
        """Prefill N same-length-group requests in one ``[N, pad_len]``
        forward and copy their caches into the arena slots."""
        n = len(reqs)
        prompts = np.zeros((n, pad_len), np.int32)
        true_lens = np.array([len(r.prompt) for r in reqs], np.int32)
        for i, req in enumerate(reqs):
            prompts[i, : len(req.prompt)] = req.prompt
        caches, last_logits, _pos = prefill_batch(
            self.params, torch.from_numpy(prompts).to(self.device), self.cfg,
            pad_len, torch.from_numpy(true_lens), kv_quantized=self.kv_quant,
        )
        firsts = torch.argmax(last_logits, dim=-1).cpu().numpy()
        t_first = time.perf_counter()  # the transfer above fenced the forward
        _write_slots(self.arena, caches,
                     torch.as_tensor(slots, dtype=torch.long, device=self.device))
        if n >= 2:
            self._batch_prefills += 1
        for i, (b, req) in enumerate(zip(slots, reqs)):
            self._finish_admission(b, req, int(firsts[i]), int(true_lens[i]),
                                   t_first)

    def _finish_admission(self, b: int, req: _Request, first: int, pos: int,
                          t_first: float) -> None:
        req.out.append(first)
        self._prefills += 1
        self._emitted += 1
        self._ttft.observe(t_first - req.t_submit)
        self._slot_req[b] = req
        self._pos[b] = pos
        self._last[b] = first
        self._maybe_finish(b, [first])

    def _maybe_finish(self, b: int, new_tokens: list) -> None:
        req = self._slot_req[b]
        if req is None:
            return
        hit_eos = self.eos_id is not None and self.eos_id in new_tokens
        if hit_eos:
            req.out = req.out[: req.out.index(self.eos_id) + 1]
        if hit_eos or len(req.out) >= req.max_new_tokens:
            self._results[req.rid] = np.asarray(req.out[: req.max_new_tokens],
                                                np.int32)
            self._slot_req[b] = None

    # ----- the round loop --------------------------------------------------

    def step(self) -> bool:
        """One lock-step round: refill free slots, then one decode chunk of
        ``chunk`` steps for every lane, fenced by the token transfer. Lanes
        past their budget decode on harmlessly (their writes clamp inside
        their own slot) and their extra tokens are trimmed. Returns False
        when queue and slots are empty."""
        self._admit()
        active = [b for b in range(self.max_batch) if self._slot_req[b] is not None]
        if not active:
            return bool(self._queue)
        t0 = time.perf_counter()
        toks, last, pos = _serve_decode(
            self.params, self.arena,
            torch.from_numpy(self._last).to(self.device),
            torch.from_numpy(self._pos).to(self.device), self.cfg, self.chunk,
            decode_kernel_fn=self._decode_kernel,
        )
        toks = toks.cpu().numpy()  # the chunk boundary: device → host fence
        self._tok_lat.observe((time.perf_counter() - t0) / self.chunk)
        self._last = last.cpu().numpy().astype(np.int32)
        self._pos = pos.cpu().numpy().astype(np.int32)
        self._rounds += 1
        for b in active:
            new = toks[b].tolist()
            self._slot_req[b].out.extend(new)
            self._emitted += len(new)
            self._maybe_finish(b, new)
        return True


def serve_batch(params: Any, cfg: DecoderConfig, prompts: list,
                max_new_tokens: int = 64, **server_kwargs) -> list[np.ndarray]:
    """Continuous-batch a list of ragged prompts; tokens in input order."""
    srv = GenerationServer(params, cfg, **server_kwargs)
    rids = [srv.submit(p, max_new_tokens) for p in prompts]
    results = srv.run()
    return [results[r] for r in rids]
