"""Continuous-batching generation server (counterpart of
``GenerationServer`` in ``kata_xpu_device_plugin_tpu/guest/serving.py``).

Two arena models are ported, both with greedy decoding in lock-step rounds
of ``chunk`` steps and batched admission through ``prefill_batch``:

- **slotted** (the default): one KV arena ``[L, max_batch, max_len, KV,
  D]`` (int8 by default); a request owns a whole slot.
- **paged** (``kv_pool_tokens``): one block pool
  (:class:`.kv_arena.KVPool`) shared by every lane through per-lane block
  tables. Admission reserves blocks for the padded prompt, tables grow one
  dispatch window ahead of decode, and under pool pressure the youngest
  lane is preempted: its written rows spill to the host and re-land
  verbatim when the pool drains, so greedy outputs do not change.

On CUDA every prefill runs the flash kernel and every decode step the paged
decode kernel: over the pool through the lanes' real block tables, or over
a zero-copy pool view of the slotted arena
(:func:`..ops.attention.make_decode_attn_fn`). The plain versions run there
only when the caller asks for ``decode_attn="reference"``, and anything the
kernels cannot take raises. On the CPU the wrappers run their plain
versions. Greedy outputs per request equal the JAX server's on the same
weights.

Arguments of the JAX server that select modes not ported yet (tensor
parallelism, speculative decoding, ring caches, the prefix cache, the host
KV tier, the block-sharded pool layout, sampling, chunked scheduling,
multi-step and persistent decode, crash recovery, and the overlapped round
loop) raise ``NotImplementedError`` when set.
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
from ..constants import (
    DEFAULT_KV_QUANT,
    ENV_DECODE_ATTN,
    ENV_KV_POOL_TOKENS,
    ENV_KV_QUANT,
)
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
from .kv_arena import (
    RESERVED_BLOCKS,
    SCRATCH_BLOCK,
    KVPool,
    pool_gather_rows,
    pool_scatter_rows,
    pool_write_batch,
    pool_write_seq,
)
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


@dataclass
class _Preempted:
    """A request spilled under pool pressure: its written KV rows on the
    host (leaves ``[L, ceil(pos/bs)*bs, ...]``), and where decode resumes."""
    req: _Request
    kv: Any
    pos: int
    last: int


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
                  decode_kernel_fn=None, block_tables=None, block_size: int = 0,
                  paged_len: int = 0):
    """One fixed-``steps`` ragged decode chunk over the arena (in place),
    through ``decode_kernel_fn``, or the plain attention when it is None.
    With ``block_tables`` the arena is the block pool and each lane decodes
    through its table. Returns ``(tokens [B, steps], last [B], pos [B])``
    on the device."""
    toks, _caches, last, pos = _decode_scan(
        params, arena, tok, pos, cfg, steps,
        attn_fn=attention.reference_attention, return_state=True,
        decode_kernel_fn=decode_kernel_fn, block_tables=block_tables,
        block_size=block_size, paged_len=paged_len,
    )
    return toks, last, pos


class GenerationServer:
    """Continuous batching over one decode arena, slotted or paged.

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
    ``prefill_buckets``, which must all be flash-kernel lengths.

    ``kv_pool_tokens`` (argument, else ``KATA_TPU_KV_POOL_TOKENS``) turns
    on the paged pool of that many tokens in blocks of ``kv_block_size``:
    ``max_batch`` becomes the number of decode lanes, and the pool, not the
    lane count, bounds the KV memory. The drained pool must hold one
    ``max_len`` request. An explicit value the server cannot run raises; a
    malformed or unusable environment value leaves the server slotted. On
    CUDA the block size must be a KV tile the paged kernel takes."""

    def __init__(self, params: Any, cfg: DecoderConfig, max_batch: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 chunk: int = 8, temperature: float = 0.0,
                 kv_quant: Optional[bool] = None, prefill_buckets: tuple = (),
                 overlap: bool = False, decode_attn: Optional[str] = None,
                 device=None,
                 kv_pool_tokens: Optional[int] = None, kv_block_size: int = 16,
                 kv_host_tokens: Optional[int] = None,
                 kv_layout: Optional[str] = None, tp: Optional[int] = None,
                 speculative_k: int = 0, ring_kv: bool = False,
                 prefix_cache_tokens: Optional[int] = None,
                 sched_policy: Optional[str] = None,
                 decode_steps: Optional[int] = None,
                 persistent: Optional[bool] = None,
                 checkpoint_rounds: Optional[int] = None):
        unported = {
            "kv_host_tokens (host KV tier, ROADMAP Queue 1 item 4)": kv_host_tokens,
            "kv_layout='blocks' (ROADMAP Queue 1 item 10)": (
                kv_layout not in (None, "heads")),
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
        self.kv_block = int(kv_block_size)
        self.kv_pool: Optional[KVPool] = None
        self.paged = self._resolve_paged(kv_pool_tokens)
        if self.paged:
            self.arena = None  # the pool is the arena: no slot grid
            self.kv_pool = KVPool(cfg, self._pool_tokens, self.kv_block,
                                  kv_quant=self.kv_quant, device=self.device)
            self._nb_max = -(-max_len // self.kv_block)
            self._lane_blocks: list[list[int]] = [[] for _ in range(max_batch)]
            # SCRATCH filler: a lane with no live request (or a finished
            # lane overrunning) writes into the scratch block, never into
            # another lane's KV.
            self._bt_host = np.full((max_batch, self._nb_max), SCRATCH_BLOCK,
                                    np.int32)
            self._plans: dict[int, list[int]] = {}
        else:
            self.arena = init_kv_caches(cfg, max_batch, max_len,
                                        device=self.device,
                                        quantized=self.kv_quant)
        self._preempted: deque[_Preempted] = deque()
        self._preemptions = 0
        self._lanes_peak = 0
        self._occupancy_peak = 0.0
        self._decode_attn, self._decode_attn_reason = (
            self._resolve_decode_attn(decode_attn))
        self._decode_kernel = None
        if self._decode_attn == BACKEND_PAGED:
            self._decode_kernel = attention.make_decode_attn_fn(
                cfg, paged=self.paged, block_size=self.kv_block,
                paged_len=max_len, arena_len=max_len, device=self.device)
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

    # ----- arena model -----------------------------------------------------

    def _resolve_paged(self, kv_pool_tokens: Optional[int]) -> bool:
        """Whether this server runs paged: explicit ``kv_pool_tokens`` >
        ``KATA_TPU_KV_POOL_TOKENS`` > slotted. A malformed environment
        value, or one this server cannot run, degrades to slotted; an
        explicit one it cannot run raises."""
        explicit = kv_pool_tokens is not None
        if not explicit:
            try:
                kv_pool_tokens = int(os.environ.get(ENV_KV_POOL_TOKENS, "") or 0)
            except ValueError:
                kv_pool_tokens = 0
        self._pool_tokens = int(kv_pool_tokens)
        if self._pool_tokens <= 0:
            return False
        reason = self._pool_conflict(self._pool_tokens)
        if reason is None:
            return True
        if explicit:
            raise ValueError(f"kv_pool_tokens={kv_pool_tokens} is incompatible "
                             f"with this server ({reason})")
        return False

    def _pool_conflict(self, pool_tokens: int) -> Optional[str]:
        """Why this server cannot run paged, or None. (The JAX server's other
        conflicts, ring caches, speculation and an injected prefix store,
        are modes that raise before this is asked.)"""
        if self.kv_block < 1:
            return f"bad_block_size:{self.kv_block}"
        usable = pool_tokens // self.kv_block - RESERVED_BLOCKS
        if usable < -(-self.max_len // self.kv_block):
            # Progress guarantee: the drained pool must hold one full-length
            # request, or the oldest request could wait forever.
            return f"pool_too_small:{pool_tokens}"
        return None

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
        """Cumulative serving counters; keys keep the JAX server's names.
        The paged-pool keys are always present (zeros when slotted).
        ``lanes_busy_peak`` and ``kv_pool_occupancy_peak`` are this
        package's own: the most lanes that decoded in one round and the
        fullest the pool was at a dispatch."""
        pool = self.kv_pool
        return {
            "rounds": self._rounds,
            "prefills": self._prefills,
            "prefill_batches": self._batch_prefills,
            "tokens_emitted": self._emitted,
            "ttft_s": self._ttft.summary(),
            "decode_token_s": self._tok_lat.summary(),
            "arena_bytes": sum(
                t.numel() * t.element_size()
                for c in (pool.arena if pool else self.arena)
                for t in (c if isinstance(c, QTensor) else (c,))),
            "decode_backend": self._decode_attn,
            "decode_backend_reason": self._decode_attn_reason,
            "kv_quant": "int8" if self.kv_quant else "bf16",
            "kv_pool_occupancy": pool.occupancy() if pool else 0.0,
            "kv_blocks_in_use": pool.blocks_in_use if pool else 0,
            "kv_blocks_total": pool.blocks_total if pool else 0,
            "kv_pool_tokens": pool.capacity_tokens if pool else 0,
            "preemptions": self._preemptions,
            "preempted_waiting": len(self._preempted),
            "lanes_busy_peak": self._lanes_peak,
            "kv_pool_occupancy_peak": self._occupancy_peak,
        }

    # ----- admission -------------------------------------------------------

    def _admit(self) -> None:
        """Refill free slots from the queue, FIFO, one ``prefill_batch`` per
        padded-length group. Loops because a request can finish during its
        own prefill (eos or a 1-token budget) and free its slot again.
        Paged: preempted requests are older than anything queued and resume
        first; a cold admission reserves its blocks before its prefill, and
        the first request the pool cannot hold stays at the head of the
        queue and ends the pass."""
        while self._queue or self._preempted:
            free = [b for b in range(self.max_batch) if self._slot_req[b] is None]
            if not free:
                return
            if self._preempted and (
                    not self._queue
                    or self._preempted[0].req.rid < self._queue[0].rid):
                if not self._resume_one(free[0]):
                    return  # strict FIFO: nothing admits past it
                continue
            groups = fifo_batch(
                self._queue, len(free), self.prefill_buckets,
                reserve=self._reserve_lane_blocks if self.paged else None)
            if not groups:
                return
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
        if not self.paged:
            _write_slots(self.arena, caches, torch.as_tensor(
                slots, dtype=torch.long, device=self.device))
        elif n == 1:
            self._paged_commit(slots[0], reqs[0], caches, 0)
        else:
            self._paged_commit_batch(slots, reqs, caches)
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
            if self.paged:
                # The table resets to SCRATCH, so what this lane still
                # writes in the round lands in the scratch block.
                self._free_lane(b)

    # ----- paged pool scheduling -------------------------------------------

    def _set_lane_table(self, b: int, table: list) -> None:
        """The one writer of a lane's block table. Entries past the
        allocation stay SCRATCH; positions <= pos always sit inside the
        allocation by construction."""
        self._lane_blocks[b] = list(table)
        self._bt_host[b, : len(table)] = table
        self._bt_host[b, len(table):] = SCRATCH_BLOCK

    def _free_lane(self, b: int) -> None:
        self.kv_pool.unref(self._lane_blocks[b])
        self._set_lane_table(b, [])

    def _reserve_lane_blocks(self, req: _Request) -> bool:
        """Reserve the blocks ``req``'s admission scatter needs, those of
        its bucket-padded rows, BEFORE its prefill forward runs: a failed
        reservation must leave the request queued, not waste a forward. The
        plan waits in ``_plans`` until the fill path commits it."""
        n = len(req.prompt)
        rows = next((k for k in self.prefill_buckets if k >= n), None) or n
        blocks = self.kv_pool.try_alloc(-(-rows // self.kv_block))
        if blocks is None:
            return False
        self._plans[req.rid] = blocks
        return True

    def _table_tensor(self, tables) -> torch.Tensor:
        return torch.from_numpy(np.asarray(tables, np.int32)).to(self.device)

    def _paged_commit(self, b: int, req: _Request, caches, row: int) -> None:
        """Land one admission's cache row in its reserved blocks and install
        the lane table."""
        table = self._plans.pop(req.rid)
        pool_write_seq(self.kv_pool.arena, caches, row,
                       self._table_tensor(table), self.kv_block)
        self._set_lane_table(b, table)

    def _paged_commit_batch(self, slots: list[int], reqs: list, caches) -> None:
        """Batched :meth:`_paged_commit`: one scatter per leaf for a whole
        same-bucket admission group. Tables are padded with SCRATCH to the
        widest plan; pad entries collide only on SCRATCH, which nothing
        reads, and never touch the ZERO block."""
        plans = [self._plans.pop(req.rid) for req in reqs]
        width = max(len(p) for p in plans)
        tables = np.full((len(plans), width), SCRATCH_BLOCK, np.int32)
        for i, plan in enumerate(plans):
            tables[i, : len(plan)] = plan
        pool_write_batch(self.kv_pool.arena, caches,
                         self._table_tensor(tables), self.kv_block)
        for b, plan in zip(slots, plans):
            self._set_lane_table(b, plan)

    def _preempt_lane(self, b: int) -> None:
        """Preempt the request in lane ``b`` under pool pressure: gather its
        written KV rows out of the pool, copy them to the host, release its
        blocks and put it on the wait list. Only the blocks that hold
        written rows (``ceil(pos / bs)``) are spilled: there is no compiled
        executable whose shape a full-width table would keep fixed. Greedy
        output is unchanged: :meth:`_resume_one` re-lands the rows verbatim
        and decode resumes at the same ``pos`` with the same ``last``."""
        req = self._slot_req[b]
        pos = int(self._pos[b])
        written = self._lane_blocks[b][: -(-pos // self.kv_block)]
        rows = pool_gather_rows(self.kv_pool.arena, self._table_tensor(written),
                                self.kv_block)
        spilled = tuple(
            QTensor(*(t.cpu() for t in c)) if isinstance(c, QTensor) else c.cpu()
            for c in rows)
        self._free_lane(b)
        # Kept sorted by rid: a pass preempts youngest first while older
        # requests may already wait, and resume order must be submit order.
        self._preempted = deque(sorted(
            [*self._preempted,
             _Preempted(req=req, kv=spilled, pos=pos, last=int(self._last[b]))],
            key=lambda p: p.req.rid))
        self._slot_req[b] = None
        self._preemptions += 1

    def _resume_one(self, b: int) -> bool:
        """Re-admit the OLDEST preempted request into lane ``b``: fresh
        blocks for its spilled rows, the rows re-landed as they were (int8
        payload and scale alike), decode resuming where the spill cut it.
        False when the pool still cannot hold it: the caller waits."""
        pre = self._preempted[0]
        blocks = self.kv_pool.try_alloc(-(-pre.pos // self.kv_block))
        if blocks is None:
            return False
        rows = tuple(
            QTensor(*(t.to(self.device) for t in c)) if isinstance(c, QTensor)
            else c.to(self.device) for c in pre.kv)
        pool_scatter_rows(self.kv_pool.arena, rows, self._table_tensor(blocks),
                          self.kv_block)
        self._set_lane_table(b, blocks)
        self._slot_req[b] = pre.req
        self._pos[b] = pre.pos
        self._last[b] = pre.last
        self._preempted.popleft()
        return True

    def _ensure_blocks(self) -> None:
        """Grow every live lane's table to cover the next dispatch window
        (``chunk`` positions past ``pos``), OLDEST request first. When the
        pool is exhausted the YOUNGEST live lane is preempted until the
        older ones fit; the head of the line always makes progress because
        the drained pool holds one full-length request. Growth is capped by
        the request's own ``prompt + max_new_tokens`` and the table width:
        writes past a finished request's budget aim at SCRATCH, so no block
        is spent on dead rows. (Rounds are lock-step here, so a lane
        preempted now is in no chunk already in flight; the overlapped loop
        will need the JAX server's fresh-row override.)"""
        if not self.paged:
            return
        bs = self.kv_block
        lanes = sorted((b for b in range(self.max_batch)
                        if self._slot_req[b] is not None),
                       key=lambda b: self._slot_req[b].rid)
        for b in lanes:
            req = self._slot_req[b]
            if req is None:
                continue  # preempted while an older lane grew
            cap = -(-(len(req.prompt) + req.max_new_tokens) // bs)
            need = min(-(-(int(self._pos[b]) + self.chunk) // bs), cap,
                       self._nb_max)
            while len(self._lane_blocks[b]) < need and self._slot_req[b] is req:
                got = self.kv_pool.try_alloc(need - len(self._lane_blocks[b]))
                if got is not None:
                    self._set_lane_table(b, self._lane_blocks[b] + got)
                    break
                self._preempt_lane(max(
                    (v for v in range(self.max_batch)
                     if self._slot_req[v] is not None),
                    key=lambda v: self._slot_req[v].rid))

    # ----- the round loop --------------------------------------------------

    def step(self) -> bool:
        """One lock-step round: refill free slots, (paged) grow the lanes'
        tables or preempt, then one decode chunk of ``chunk`` steps for
        every lane, fenced by the token transfer. Lanes past their budget
        decode on harmlessly (their writes clamp inside their own slot, or
        land in the scratch block) and their extra tokens are trimmed.
        Returns False when queue, wait list and slots are empty."""
        self._admit()
        self._ensure_blocks()
        active = [b for b in range(self.max_batch) if self._slot_req[b] is not None]
        if not active:
            return bool(self._queue) or bool(self._preempted)
        self._lanes_peak = max(self._lanes_peak, len(active))
        paged_kw = {}
        if self.paged:
            self._occupancy_peak = max(self._occupancy_peak,
                                       self.kv_pool.occupancy())
            # The tables ride each dispatch as a fresh device copy of a
            # snapshot: later host-side edits cannot reach a round in flight.
            paged_kw = dict(block_tables=self._table_tensor(self._bt_host.copy()),
                            block_size=self.kv_block, paged_len=self.max_len)
        t0 = time.perf_counter()
        toks, last, pos = _serve_decode(
            self.params, self.kv_pool.arena if self.paged else self.arena,
            torch.from_numpy(self._last).to(self.device),
            torch.from_numpy(self._pos).to(self.device), self.cfg, self.chunk,
            decode_kernel_fn=self._decode_kernel, **paged_kw,
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
