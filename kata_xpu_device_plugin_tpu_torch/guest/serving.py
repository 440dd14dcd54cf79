"""Continuous-batching generation server (counterpart of
``GenerationServer`` in ``kata_xpu_device_plugin_tpu/guest/serving.py``).

Two arena models are ported, both decoding greedily or by sampling
(``temperature``, ``top_k``, ``top_p`` from a generator seeded with
``seed``) in dispatches of ``chunk × decode_steps`` steps, with batched
admission through ``prefill_batch``:

- **slotted** (the default): one KV arena ``[L, max_batch, max_len, KV,
  D]`` (int8 by default); a request owns a whole slot.
- **paged** (``kv_pool_tokens``): one block pool
  (:class:`.kv_arena.KVPool`) shared by every lane through per-lane block
  tables. Admission reserves blocks for the padded prompt, tables grow one
  dispatch window ahead of decode, and under pool pressure the youngest
  lane is preempted: its written rows spill to the host and re-land
  verbatim when the pool drains, so greedy outputs do not change.

Two round loops, as in the JAX server:

- **overlapped** (``overlap=True``, the default): the next chunk is
  dispatched from the in-flight chunk's ``last``/``pos`` on the device,
  with the rows admission refilled since merged in from the host, and only
  then is the in-flight chunk retired through its
  :class:`..obs.trace.DeviceFence`; finish detection and admission run
  while the card computes. Tokens the in-flight chunk decoded for a lane
  that finished, or was preempted, meanwhile are dropped at retire.
- **lock-step** (``overlap=False``): admit, dispatch, wait for the tokens.

``decode_steps=K`` (argument, else ``KATA_TPU_DECODE_STEPS``) makes one
dispatch ``chunk × K`` steps, with every lane frozen on the device once it
has its budget or emits ``eos_id``. Greedy outputs do not depend on the
loop or on K.

Admission scheduling (``guest/scheduler.py``): ``sched_policy=
"slo_chunked"`` slices an admission into ``prefill_chunk``-token
``prefill_suffix`` chunks while requests decode and the projected
per-token latency of a whole prefill exceeds ``itl_slo_ms``; at most one
chunk runs per decode dispatch, and with ``fused`` (on by default under
``slo_chunked``) the chunk rides the decode dispatch itself. With
``persistent=True`` (greedy only) each round decodes on the card until a
cap, a lane's freeze, or a live lane's reserved window edge
(:class:`.decode_graph.PersistentRound`), and rounds run lock-step.
Neither changes greedy outputs.

The shared-prefix KV cache (``prefix_cache_tokens``, else
``KATA_TPU_PREFIX_CACHE_TOKENS``; or an injected ``prefix_store``): an
admission looks its prompt up in a radix index of cached bucket-aligned
prefixes, and a hit copies the prefix rows and prefills only the suffix
(``prefill_suffix``), batched across hits on one segment. Slotted, the
cache is a :class:`.prefix_cache.PrefixStore` of its own; paged, it is a
:class:`.kv_arena.PagedPrefixTier` inside the pool whose fully covered
blocks a hit's table shares (its boundary block copied on write).
``kv_host_tokens`` (else ``KATA_TPU_KV_HOST_TOKENS``; paged only) adds a
host-RAM tier below the pool: pool pressure demotes unpinned prefix
segments there before any lane is preempted, a hit on one promotes it
back, preemption spills are accounted there, and the oldest preempted
request's rows are uploaded on a side stream while a chunk decodes, so
its resume lands them without waiting. None of this changes greedy
outputs.

On CUDA every whole prefill runs the flash kernel and every decode step
the paged decode kernel: over the pool through the lanes' real block
tables, or over a zero-copy pool view of the slotted arena
(:func:`..ops.attention.make_decode_attn_fn`); each decode chunk after the
first is one CUDA graph replay (:class:`.decode_graph.DecodeGraph`), its
random draws included. A chunk slice reads the cache back, so by the JAX
rule it takes the plain attention. As in the JAX server, a config with a
sliding window or an attention-logit softcap, masks the kernel does not
model, decodes with the plain attention and says why in ``stats()``;
otherwise the plain versions run on the card only when the caller asks for
``decode_attn="reference"``, and anything the kernels cannot take raises.
On the CPU the wrappers run their plain versions and chunks run eagerly.
Greedy outputs per request equal the JAX server's on the same weights, as
do the round, admission, chunk and persistent-exit counts under the same
settings; sampled outputs repeat under one seed.

Tensor-parallel serving (``tp``, else ``KATA_TPU_TP`` and the topology
env, :mod:`.tp_serving`): the server splits its parameters into ``tp``
shards by the serving rules and runs every forward across them,
column-parallel q/k/v and gate/up, row-parallel ``wo`` and ``w_down`` each
followed by the sum across shards, every shard attending with its own
query heads. ``kv_layout`` picks the placement of the KV state: ``"heads"``
splits the KV heads where they divide ``tp`` (else every shard reads every
KV head), ``"blocks"`` (paged only) splits the pool into per-shard
sub-pools of whole blocks, and decode attention then runs the shard-local
paged kernel on each shard and merges the shards' softmax statistics.
Every shard lives on the server's one device (a port-only difference:
JAX places them on distinct chips); greedy outputs equal ``tp=1``'s.

Arguments of the JAX server that select modes not ported yet (a
caller's training-layout ``mesh``, speculative decoding, ring caches,
telemetry, fault injection and crash recovery, the degraded mesh shrink)
raise ``NotImplementedError`` naming their ROADMAP item when set to
anything but their no-op value.
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
    ENV_DECODE_STEPS,
    ENV_FUSED,
    ENV_ITL_SLO_MS,
    ENV_KV_HOST_TOKENS,
    ENV_KV_LAYOUT,
    ENV_KV_POOL_TOKENS,
    ENV_KV_QUANT,
    ENV_PERSISTENT,
    ENV_PREFILL_CHUNK,
    ENV_PREFIX_CACHE_TOKENS,
    ENV_SCHED_POLICY,
)
from ..models.transformer import (
    DecoderConfig,
    _next_token,
    _sampling_args,
    check_supported,
    init_kv_caches,
    prefill_batch,
    prefill_suffix,
    tp_serving_params,
)
from ..obs.metrics import Rolling
from ..obs.trace import DeviceFence
from ..ops import attention
from ..ops.quant import QTensor
from . import tp_serving
from .decode_graph import DecodeGraph, PersistentRound, Sampling
from .kv_arena import (
    RESERVED_BLOCKS,
    SCRATCH_BLOCK,
    HostKVTier,
    KVPool,
    PagedPrefixTier,
    pool_gather_rows,
    pool_scatter_rows,
    pool_write_batch,
    pool_write_seq,
    rows_to_device,
    rows_to_host,
    table_tensor,
)
from .prefix_cache import PrefixHit, PrefixStore, cache_bytes, cache_leaves
from .scheduler import (
    DEFAULT_ITL_SLO_MS,
    DEFAULT_PREFILL_CHUNK,
    POLICIES,
    POLICY_FIFO,
    POLICY_SLO,
    make_scheduler,
)
from .tp_serving import KV_LAYOUT_BLOCKS, KV_LAYOUT_HEADS, KV_LAYOUTS, ServingMesh

BACKEND_PAGED = attention.BACKEND_PAGED
BACKEND_REFERENCE = attention.BACKEND_REFERENCE

# Decode rounds one persistent round may span at most (the JAX server's
# heartbeat cadence, whose default bounds the cap there too): the cap is
# max(min(chunk × decode_steps × this, max_len), chunk × decode_steps).
PERSISTENT_CAP_ROUNDS = 32
PERSISTENT_EXITS = ("cap", "done", "window")


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


def _env_int(name: str, default: int) -> int:
    """An integer env knob; unset or malformed gives ``default``."""
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _resolve_tokens(value: Optional[int], env: str) -> tuple[int, bool]:
    """A token-count knob: ``(tokens, explicit)``, the argument when given,
    else the env value, which degrades to 0 when malformed or negative."""
    if value is not None:
        return int(value), True
    return max(_env_int(env, 0), 0), False


def _env_flag(name: str) -> Optional[bool]:
    """A ``"0"``/``"1"`` env knob: its value, or None when unset or
    malformed (which degrades to the knob's default)."""
    raw = os.environ.get(name, "").strip()
    return {"0": False, "1": True}.get(raw)


def resolve_kv_layout(kv_layout: Optional[str]) -> tuple[str, bool]:
    """``(layout, explicit)``: an explicit unknown layout raises; an
    unknown ``KATA_TPU_KV_LAYOUT`` degrades to ``"heads"``."""
    if kv_layout is not None:
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"unknown kv_layout {kv_layout!r} (have {KV_LAYOUTS})")
        return kv_layout, True
    raw = os.environ.get(ENV_KV_LAYOUT, "").strip()
    return (raw if raw in KV_LAYOUTS else KV_LAYOUT_HEADS), False


def tp_conflict(cfg: DecoderConfig, tp: int, ring_kv: bool,
                speculative: bool) -> Optional[str]:
    """Why this server cannot serve at degree ``tp``, or None: the JAX
    server's reasons (ring caches and speculation re-layout or add caches
    the serving rules do not cover), and this package's own, a split the
    shards cannot take (every shard holds whole query heads and an equal
    share of the KV features and of the MLP)."""
    if tp <= 1:
        return None
    if ring_kv:
        return "ring_kv"
    if speculative:
        return "speculative"
    for name, n in (("n_heads", cfg.n_heads), ("kv_dim", cfg.kv_dim),
                    ("d_ff", cfg.d_ff)):
        if n % tp:
            return f"indivisible:{name}={n}"
    return None


def resolve_tp(tp: Optional[int], cfg: DecoderConfig, ring_kv: bool = False,
               speculative: bool = False) -> int:
    """The serving degree: an explicit ``tp`` (< 1 or in
    :func:`tp_conflict` raises; more shards than devices share the one
    device), else :func:`.tp_serving.tp_from_env`, which degrades to 1 on
    a conflict."""
    if tp is not None:
        tp = int(tp)
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        reason = tp_conflict(cfg, tp, ring_kv, speculative)
        if reason is not None:
            raise ValueError(f"tp={tp} is incompatible with this server "
                             f"({reason})")
        return tp
    tp = tp_serving.tp_from_env()
    return 1 if tp_conflict(cfg, tp, ring_kv, speculative) else tp


def resolve_kv_quant(kv_quant) -> bool:
    """Explicit argument > ``KATA_TPU_KV_QUANT`` ("int8" | "bf16") > int8.
    A malformed env value degrades to the default."""
    if kv_quant is not None:
        return bool(kv_quant)
    raw = os.environ.get(ENV_KV_QUANT, "").strip().lower()
    if raw not in ("int8", "bf16"):
        raw = DEFAULT_KV_QUANT
    return raw == "int8"


def resolve_decode_steps(decode_steps: Optional[int]) -> int:
    """K, the decode chunks one dispatch runs: explicit argument >
    ``KATA_TPU_DECODE_STEPS`` > 1. An explicit value < 1 raises; a
    malformed or < 1 env value degrades to 1."""
    if decode_steps is not None:
        if int(decode_steps) < 1:
            raise ValueError(f"decode_steps must be >= 1, got {decode_steps}")
        return int(decode_steps)
    return max(_env_int(ENV_DECODE_STEPS, 1), 1)


def resolve_sched(sched_policy: Optional[str], prefill_chunk: Optional[int],
                  itl_slo_ms: Optional[float]) -> tuple[str, int, float]:
    """``(policy, chunk tokens, slo ms)``, the JAX server's rules: an
    explicit unknown policy or a ``prefill_chunk`` < 1 raises; an unknown
    ``KATA_TPU_SCHED_POLICY`` degrades to ``fifo_batch``, a malformed or
    < 1 ``KATA_TPU_PREFILL_CHUNK`` to 128 and a malformed
    ``KATA_TPU_ITL_SLO_MS`` to 50."""
    if sched_policy is None:
        sched_policy = os.environ.get(ENV_SCHED_POLICY, "").strip() or POLICY_FIFO
        if sched_policy not in POLICIES:
            sched_policy = POLICY_FIFO
    elif sched_policy not in POLICIES:
        raise ValueError(
            f"unknown sched_policy {sched_policy!r} (have {POLICIES})")
    if prefill_chunk is not None:
        if int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 token, got {prefill_chunk}")
        chunk_tokens = int(prefill_chunk)
    else:
        chunk_tokens = _env_int(ENV_PREFILL_CHUNK, DEFAULT_PREFILL_CHUNK)
        if chunk_tokens < 1:
            chunk_tokens = DEFAULT_PREFILL_CHUNK
    if itl_slo_ms is not None:
        slo_ms = float(itl_slo_ms)
    else:
        try:
            slo_ms = float(os.environ.get(ENV_ITL_SLO_MS, "") or DEFAULT_ITL_SLO_MS)
        except ValueError:
            slo_ms = DEFAULT_ITL_SLO_MS
    return sched_policy, chunk_tokens, slo_ms


def resolve_fused(fused: Optional[bool], sched_policy: str) -> bool:
    """Whether chunk slices ride decode dispatches: on under
    ``slo_chunked`` unless ``KATA_TPU_FUSED=0`` (a malformed value
    degrades to on), off otherwise; an explicit ``fused=True`` without
    ``slo_chunked`` raises."""
    if fused is not None:
        if fused and sched_policy != POLICY_SLO:
            raise ValueError(
                "fused=True requires sched_policy='slo_chunked': only chunked "
                "admission makes the slices a fused dispatch carries")
        return bool(fused)
    return sched_policy == POLICY_SLO and _env_flag(ENV_FUSED) is not False


def resolve_persistent(persistent: Optional[bool], do_sample: bool) -> bool:
    """Whether rounds are persistent: explicit argument >
    ``KATA_TPU_PERSISTENT`` ("1" on; malformed degrades to off) > off. The
    round is greedy only: on a sampling server an explicit
    ``persistent=True`` raises and the env value degrades."""
    explicit = persistent is not None
    on = bool(persistent) if explicit else _env_flag(ENV_PERSISTENT) is True
    if on and do_sample:
        if explicit:
            raise ValueError(
                "persistent=True is incompatible with this server (sampling): "
                "persistent rounds are greedy only")
        return False
    return on


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
    host (leaves ``[L, ceil(pos/bs)*bs, ...]``, pinned on CUDA), and where
    decode resumes. ``ready``: on CUDA an event recorded after the rows'
    copy to the host, which a staged upload on another stream waits for."""
    req: _Request
    kv: Any
    pos: int
    last: int
    ready: Optional[torch.cuda.Event] = None


@dataclass
class _ResumeStage:
    """The staged resume prefetch: request ``rid``'s spilled rows uploaded
    on the side stream into ``rows``; ``done`` is recorded there after the
    upload, ``src`` the pinned rows it reads."""
    rid: int
    rows: Any
    done: Optional[torch.cuda.Event] = None
    src: Any = None


@dataclass
class _LanePlan:
    """A paged admission's block reservation, made before its prefill
    forward. ``table[:n_shared]`` are prefix-tier blocks the lane reads and
    never writes (pool references); the admission scatter masks them with
    SCRATCH. When the match is not block-aligned, the partly covered
    boundary block is the first private entry, filled from the
    materialized cache: the copy on write."""
    table: list
    n_shared: int


@dataclass
class _PartialPrefill:
    """One chunked admission in progress: the queue head's prompt,
    prefilled in ``prefill_chunk``-token slices between decode rounds into
    its own ``[L, 1, max_len, ...]`` caches. It lands in a lane (arena
    write, first token) only when the last slice has run, through the
    same ``_finish_admission`` as every other admission. Head-of-line:
    while it exists nothing else admits or resumes."""
    req: _Request
    hit: Optional[PrefixHit]
    caches: Any
    offset: int     # prompt rows already resident (prefix reuse and chunks)
    fused: int = 0  # chunks that rode a decode dispatch


@dataclass
class _FusedChunk:
    """One admission slice that rode a decode dispatch (its partial's
    ``offset`` advanced at dispatch, so an overlapped pipeline carries the
    next slice in the next dispatch) and the slice's last-position logits
    on the device. ``last``: the final slice, whose retire samples the
    first token and lands the admission."""
    partial: _PartialPrefill
    last: bool
    logits: torch.Tensor


@dataclass
class _Inflight:
    """The dispatched, not yet retired decode chunk of the overlapped loop.
    ``last``/``pos`` are its outputs on the device, which the next chunk
    starts from; ``fence`` is their copy to the host, with the tokens.
    ``slots`` pins the (lane, request) pairs at dispatch: a lane refilled
    or preempted while the chunk was in flight fails the identity check at
    retire, and its tokens are dropped."""
    fence: DeviceFence
    last: torch.Tensor
    pos: torch.Tensor
    slots: list
    t_dispatch: float
    fused: Optional[_FusedChunk] = None  # an admission slice riding along


def _merge_rows(dev_vals: torch.Tensor, host_vals: torch.Tensor,
                fresh: torch.Tensor) -> torch.Tensor:
    """The overlapped dispatch's input: the in-flight chunk's rows on the
    device, with the rows the host refilled since the last dispatch
    (``fresh``) taken from the host."""
    return torch.where(fresh, host_vals, dev_vals)


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


class GenerationServer:
    """Continuous batching over one decode arena, slotted or paged.

    >>> srv = GenerationServer(params, cfg, max_batch=4, max_len=512)
    >>> rid = srv.submit(prompt_tokens, max_new_tokens=64)
    >>> results = srv.run()          # {rid: np.ndarray of generated tokens}

    ``temperature > 0`` samples every token (with ``top_k``/``top_p``,
    :func:`..models.transformer.sample_token`) from :attr:`generator`, a
    ``torch.Generator`` on the server's device seeded with ``seed``.
    ``kv_quant=None`` resolves int8 KV unless ``KATA_TPU_KV_QUANT=bf16``.
    ``decode_attn`` picks the decode attention: ``"cuda_paged"`` (the
    kernel; its plain version on the CPU) or ``"reference"`` (the plain
    attention over the arena); None reads ``KATA_TPU_DECODE_ATTN``, then
    chooses the kernel on CUDA and the plain attention on the CPU, and the
    plain attention wherever the config has a sliding window or an
    attention-logit softcap (JAX's rule). An explicit ``"cuda_paged"``
    the config rules out, or a kernel that cannot take the config's
    shapes, raises. ``device`` defaults to
    CUDA and must hold ``params``; there every prompt is padded to one of
    ``prefill_buckets``, which must all be flash-kernel lengths.

    ``kv_pool_tokens`` (argument, else ``KATA_TPU_KV_POOL_TOKENS``) turns
    on the paged pool of that many tokens in blocks of ``kv_block_size``:
    ``max_batch`` becomes the number of decode lanes, and the pool, not the
    lane count, bounds the KV memory. The drained pool must hold one
    ``max_len`` request. An explicit value the server cannot run raises; a
    malformed or unusable environment value leaves the server slotted. On
    CUDA the block size must be a KV tile the paged kernel takes.

    ``overlap`` picks the round loop (pipelined by default, as in the JAX
    server) and ``decode_steps`` the chunks a dispatch runs (module doc).
    ``sched_policy`` (else ``KATA_TPU_SCHED_POLICY``, else
    ``"fifo_batch"``), ``prefill_chunk`` (``KATA_TPU_PREFILL_CHUNK``,
    128), ``itl_slo_ms`` (``KATA_TPU_ITL_SLO_MS``, 50) and ``fused``
    (``KATA_TPU_FUSED``, on under ``"slo_chunked"``) pick the admission
    schedule; ``persistent`` (``KATA_TPU_PERSISTENT``, off) the persistent
    rounds. Explicit values the server cannot take raise; env values
    degrade to the defaults, as in the JAX server.
    :meth:`request_drain` and :meth:`drain` stop admission: started work,
    preempted spills included, runs to its end, and what never started
    fails into :meth:`failures`.

    ``prefix_cache_tokens`` (else ``KATA_TPU_PREFIX_CACHE_TOKENS``) > 0
    turns on the prefix cache (module doc): a slotted server's
    :class:`.prefix_cache.PrefixStore` of that many tokens, a paged
    server's tier in its pool. ``prefix_store`` injects a store, which may
    back several slotted servers; its config, buckets, KV dtype and device
    must be this server's, and it keeps an env pool size from paging the
    server (an explicit one raises). The cache needs ``prefill_buckets``:
    without them an explicit size or store raises, an env size degrades.
    ``kv_host_tokens`` (else ``KATA_TPU_KV_HOST_TOKENS``) sizes the host
    tier of a paged server: explicit values < 0, or > 0 on a slotted
    server, raise; env values degrade to 0.

    ``tp`` (else ``KATA_TPU_TP`` and the topology env) serves across that
    many shards of the server's device (module doc); ``kv_layout`` (else
    ``KATA_TPU_KV_LAYOUT``, else ``"heads"``) places the KV state:
    ``"blocks"`` needs a paged pool (explicit on a slotted server raises,
    the env value degrades to ``"heads"``) and makes the pool one
    sub-pool a shard. An explicit ``tp`` below 1, with ``ring_kv`` or
    ``speculative_k``, or one the model's heads, KV features or MLP do
    not divide, raises; the env value degrades to 1. ``tp_min`` is
    validated as in the JAX server; the mesh shrink it floors is not
    ported."""

    def __init__(self, params: Any, cfg: DecoderConfig, max_batch: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 chunk: int = 8, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 kv_quant: Optional[bool] = None, prefill_buckets: tuple = (),
                 overlap: bool = True, decode_attn: Optional[str] = None,
                 device=None,
                 kv_pool_tokens: Optional[int] = None, kv_block_size: int = 16,
                 kv_host_tokens: Optional[int] = None,
                 kv_layout: Optional[str] = None, tp: Optional[int] = None,
                 speculative_k: int = 0, ring_kv: bool = False,
                 prefix_cache_tokens: Optional[int] = None,
                 prefix_store: Optional[PrefixStore] = None,
                 sched_policy: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 itl_slo_ms: Optional[float] = None,
                 fused: Optional[bool] = None,
                 decode_steps: Optional[int] = None,
                 persistent: Optional[bool] = None,
                 checkpoint_rounds: Optional[int] = None,
                 mesh: Any = None, draft: Optional[tuple] = None,
                 strict: Optional[bool] = None,
                 tripwire: Optional[bool] = None,
                 fault_injector: Any = None,
                 fence_timeout_s: Optional[float] = None,
                 quarantine_after: Optional[int] = None,
                 recovery_backoff_s: Optional[float] = None,
                 spec_opt_in: Optional[bool] = None,
                 tp_min: Optional[int] = None,
                 degraded: Optional[bool] = None,
                 heartbeat_rounds: Optional[int] = None,
                 watchdog: Any = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self._tp = resolve_tp(tp, cfg, ring_kv,
                              bool(speculative_k) or draft is not None)
        unported = {
            "mesh= (a caller's training-layout mesh, ROADMAP Queue 1 item 12b)":
                mesh is not None,
            "speculative_k (ROADMAP Queue 1 item 11b)": speculative_k,
            "draft (speculative decoding, ROADMAP Queue 1 item 11b)":
                draft is not None,
            "spec_opt_in (speculative decoding, ROADMAP Queue 1 item 11b)":
                spec_opt_in,
            "ring_kv (ROADMAP Queue 1 item 11b)": ring_kv,
            "strict (transfer guard, ROADMAP Queue 1 item 9a)": strict,
            "tripwire (steady-state census, ROADMAP Queue 1 item 9a)": tripwire,
            "heartbeat_rounds (telemetry, ROADMAP Queue 1 item 9a)":
                heartbeat_rounds,
            "watchdog (telemetry, ROADMAP Queue 1 item 9a)":
                watchdog not in (None, False),
            "checkpoint_rounds (recovery, ROADMAP Queue 1 item 9b)":
                checkpoint_rounds,
            "fault_injector (resilience, ROADMAP Queue 1 item 9b)":
                fault_injector is not None,
            "fence_timeout_s (resilience, ROADMAP Queue 1 item 9b)":
                fence_timeout_s is not None,
            "quarantine_after (resilience, ROADMAP Queue 1 item 9b)":
                quarantine_after is not None,
            "recovery_backoff_s (resilience, ROADMAP Queue 1 item 9b)":
                recovery_backoff_s is not None,
            "degraded=True (the mesh shrink needs fault detection, ROADMAP "
            "Queue 1 item 9b)": degraded is True,
        }
        for what, value in unported.items():
            if value:
                raise NotImplementedError(f"{what} is not ported yet")
        # The shrink ladder's floor, validated as in the JAX server; the
        # shrink itself is not ported (degraded=True raises above).
        if tp_min is not None and int(tp_min) < 1:
            raise ValueError(f"tp_min must be >= 1, got {tp_min}")
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
        self.cfg = cfg
        # The shards of a tensor-parallel server (every one on this device);
        # params split across them by the serving rules.
        self._mesh = (ServingMesh.for_config(cfg, self._tp, self.device)
                      if self._tp > 1 else None)
        self.params = (tp_serving_params(params, cfg, self._mesh)
                       if self._mesh is not None else params)
        self.max_batch, self.max_len = max_batch, max_len
        self.eos_id, self.chunk = eos_id, chunk
        self.top_k, self.top_p = top_k, top_p
        # Every draw of the server, at admission and inside the decode
        # chunks, comes from this generator, in the order the host issues
        # them: one seed gives the same tokens run after run.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._do_sample = _sampling_args(temperature, top_k, self.generator,
                                         top_p)
        # Device-resident temperature, made once: no per-dispatch upload.
        self._temp_dev = (torch.full((), float(temperature), dtype=torch.float32,
                                     device=self.device)
                          if self._do_sample else None)
        self.overlap = bool(overlap)
        self._decode_steps = resolve_decode_steps(decode_steps)
        # Steps of one dispatch: ITL, the budget gate and the paged
        # lookahead key off this, never off ``chunk`` alone.
        self._dispatch_steps = chunk * self._decode_steps
        policy, chunk_tokens, slo_ms = resolve_sched(
            sched_policy, prefill_chunk, itl_slo_ms)
        self._fused_ok = resolve_fused(fused, policy)
        self._sched = make_scheduler(
            policy, chunk_tokens=chunk_tokens, slo_ms=slo_ms,
            decode_steps=self._dispatch_steps, fused=self._fused_ok)
        self._partial: Optional[_PartialPrefill] = None
        self._fuse_pending = False
        self._fused_ret: Optional[_FusedChunk] = None
        self._fused_admissions = 0
        self._persistent = resolve_persistent(persistent, self._do_sample)
        # A persistent round's step cap, a static of its executable.
        self._persistent_cap = max(
            min(self._dispatch_steps * PERSISTENT_CAP_ROUNDS, max_len),
            self._dispatch_steps) if self._persistent else 0
        self._persistent_rounds = 0
        self._last_delivered = 0
        self._delivered_total = 0
        self._delivered_lane_steps = 0
        self._persistent_exits = dict.fromkeys(PERSISTENT_EXITS, 0)
        self._persistent_fut: Optional[tuple] = None  # (delivered, window)
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.kv_block = int(kv_block_size)
        self.kv_pool: Optional[KVPool] = None
        # Set before the pool resolves: the blocks layout rounds the pool
        # to whole blocks a shard.
        self._kv_layout, explicit_layout = resolve_kv_layout(kv_layout)
        host_tokens, explicit_host = _resolve_tokens(kv_host_tokens,
                                                     ENV_KV_HOST_TOKENS)
        if host_tokens < 0:
            raise ValueError(f"kv_host_tokens must be >= 0, got {host_tokens}")
        self.paged = self._resolve_paged(kv_pool_tokens, prefix_store)
        if not self.paged and self._kv_layout == KV_LAYOUT_BLOCKS:
            if explicit_layout:
                raise ValueError("kv_layout='blocks' requires a paged KV pool "
                                 "(kv_pool_tokens)")
            self._kv_layout = KV_LAYOUT_HEADS
        if not self.paged and host_tokens > 0:
            if explicit_host:
                raise ValueError("kv_host_tokens requires a paged KV pool "
                                 "(kv_pool_tokens)")
            host_tokens = 0
        self._kv_host = (HostKVTier(host_tokens, self.kv_block)
                         if host_tokens > 0 else None)
        if self.paged:
            self.arena = None  # the pool is the arena: no slot grid
            self.kv_pool = KVPool(cfg, self._pool_tokens, self.kv_block,
                                  kv_quant=self.kv_quant,
                                  shards=self._kv_shards(), device=self.device)
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
        self.prefix_store = self._make_prefix_store(prefix_cache_tokens,
                                                    prefix_store)
        # The per-server prefix counters (a store may back several
        # servers), and each lane's pinned hit, released at its finish.
        self._slot_prefix: list[Optional[PrefixHit]] = [None] * max_batch
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_tokens_reused = 0
        self._cow_copies = 0
        # Host-tier traffic of preemption spills (the tier's own demotions
        # and promotions count in the tier) and the staged resume upload.
        self._host_demotions = 0
        self._host_prefetches = 0
        self._resume_staged = 0
        self._stage: Optional[_ResumeStage] = None
        self._h2d_stream = None
        self._h2d_inflight: list[_ResumeStage] = []
        self._preempted: deque[_Preempted] = deque()
        self._preemptions = 0
        self._lanes_peak = 0
        self._occupancy_peak = 0.0
        self._shard_peak = [0.0] * self._tp
        self._decode_attn, self._decode_attn_reason = (
            self._resolve_decode_attn(decode_attn))
        decode_kernel = None
        if self._decode_attn == BACKEND_PAGED:
            decode_kernel = attention.make_decode_attn_fn(
                cfg, paged=self.paged, block_size=self.kv_block,
                paged_len=max_len, arena_len=max_len, device=self.device,
                mesh=self._mesh, kv_layout=self._kv_layout)
        params = self.params
        arena = self.kv_pool.arena if self.paged else self.arena
        paged_kw = dict(table_width=self._nb_max if self.paged else 0,
                        block_size=self.kv_block if self.paged else 0,
                        paged_len=max_len if self.paged else 0)
        # Persistent servers arm the budget mask on every dispatch, the
        # fixed-step chunk of a fused round included (as in JAX).
        self._decode = DecodeGraph(
            params, arena, cfg, batch=max_batch, steps=self._dispatch_steps,
            device=self.device, decode_kernel_fn=decode_kernel,
            budget=self._decode_steps > 1 or self._persistent, eos_id=eos_id,
            sampling=Sampling(self.generator, self._temp_dev, top_k, top_p)
            if self._do_sample else None, **paged_kw)
        self._round = PersistentRound(
            params, arena, cfg, batch=max_batch, cap=self._persistent_cap,
            device=self.device, decode_kernel_fn=decode_kernel,
            eos_id=eos_id, **paged_kw) if self._persistent else None
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
        # The overlapped loop: the chunk in flight, the lanes refilled since
        # the last dispatch, and the retire clock ITL is read from.
        self._inflight: Optional[_Inflight] = None
        self._fresh_rows: set[int] = set()
        self._t_last_retire = 0.0
        self._draining = False
        self._drain_reason = ""
        self._drain_done = False

    # ----- arena model -----------------------------------------------------

    def _make_prefix_store(self, tokens: Optional[int], injected):
        """The prefix cache by the JAX server's rules (class doc), or
        None."""
        tokens, explicit = _resolve_tokens(tokens, ENV_PREFIX_CACHE_TOKENS)
        if injected is None and tokens <= 0:
            return None
        if not self.prefill_buckets:
            if explicit or injected is not None:
                raise ValueError(
                    "prefix caching requires prefill_buckets: matches are "
                    "bucket-aligned")
            return None
        if self.paged:
            return PagedPrefixTier(self.kv_pool, self.cfg, self.prefill_buckets,
                                   host_tier=self._kv_host)
        if injected is not None:
            if (injected.cfg != self.cfg
                    or injected.buckets != self.prefill_buckets
                    or injected.kv_quant != self.kv_quant
                    or injected.dtype != self.cfg.dtype
                    or injected.device != self.device):
                raise ValueError(
                    "injected prefix_store does not match this server (cfg, "
                    "prefill_buckets, kv_quant, cache dtype and device must "
                    "agree: its rows land verbatim in this arena)")
            return injected
        return PrefixStore(self.cfg, tokens, self.prefill_buckets,
                           kv_quant=self.kv_quant, device=self.device)

    def _resolve_paged(self, kv_pool_tokens: Optional[int],
                       prefix_store) -> bool:
        """Whether this server runs paged: explicit ``kv_pool_tokens`` >
        ``KATA_TPU_KV_POOL_TOKENS`` > slotted. A malformed environment
        value, or one this server cannot run, degrades to slotted; an
        explicit one it cannot run raises."""
        explicit = kv_pool_tokens is not None
        if not explicit:
            kv_pool_tokens = _env_int(ENV_KV_POOL_TOKENS, 0)
        self._pool_tokens = int(kv_pool_tokens)
        if self._pool_tokens <= 0:
            return False
        reason = self._pool_conflict(self._pool_tokens, prefix_store)
        if reason is None:
            return True
        if explicit:
            raise ValueError(f"kv_pool_tokens={kv_pool_tokens} is incompatible "
                             f"with this server ({reason})")
        return False

    def _pool_conflict(self, pool_tokens: int, prefix_store) -> Optional[str]:
        """Why this server cannot run paged, or None. An injected prefix
        store is one: the pool's own tier is the paged prefix path. (The
        JAX server's other conflicts, ring caches and speculation, are
        modes that raise before this is asked.)"""
        if self.kv_block < 1:
            return f"bad_block_size:{self.kv_block}"
        if prefix_store is not None:
            return "injected_prefix_store"
        shards = self._kv_shards()
        usable = (pool_tokens // self.kv_block) // shards * shards - RESERVED_BLOCKS
        if usable < -(-self.max_len // self.kv_block):
            # Progress guarantee: the drained pool must hold one full-length
            # request, or the oldest request could wait forever.
            return f"pool_too_small:{pool_tokens}"
        return None

    def _kv_shards(self) -> int:
        """The pool's sub-pools: the degree under the blocks layout, else
        1."""
        return self._tp if self._kv_layout == KV_LAYOUT_BLOCKS else 1

    # ----- decode backend --------------------------------------------------

    def _resolve_decode_attn(self, choice: Optional[str]):
        """``(backend, reason)``: explicit argument > env > automatic. The
        config decides first, as in the JAX server: one the kernel cannot
        model decodes with the plain attention, and the reason says why;
        an explicit ``"cuda_paged"`` for it raises, an env one degrades.
        Otherwise the automatic pick is the kernel on CUDA and the plain
        attention on the CPU. A malformed env value is ignored; the plain
        attention runs on the card otherwise only when asked for."""
        explicit = choice is not None
        if choice is None:
            raw = os.environ.get(ENV_DECODE_ATTN, "").strip()
            choice = raw if raw in attention.DECODE_ATTN_BACKENDS else None
        elif choice not in attention.DECODE_ATTN_BACKENDS:
            raise ValueError(f"unknown decode_attn {choice!r} "
                             f"(have {attention.DECODE_ATTN_BACKENDS})")
        if choice == BACKEND_REFERENCE:
            return choice, "forced"
        # The JAX server's other reasons, ring caches and speculation, are
        # modes that raise before this is asked.
        conflict = attention.decode_kernel_conflict(self.cfg)
        if conflict is not None:
            if explicit:
                raise ValueError(
                    f"decode_attn={BACKEND_PAGED!r} is incompatible with this "
                    f"server ({conflict})")
            return BACKEND_REFERENCE, conflict
        if choice is not None:
            return choice, "forced"
        if self.device.type != "cuda":
            return BACKEND_REFERENCE, "cpu_backend"
        return BACKEND_PAGED, ""

    # ----- public API ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 64) -> int:
        if self._draining:
            raise RuntimeError(
                f"server is draining ({self._drain_reason or 'requested'}): "
                "not accepting new requests")
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
        """Per-request terminal failures, ``{rid: error}``: the requests a
        drain failed before they started (or a preempted one the drained
        pool could not re-admit). Without crash recovery (not ported) an
        error propagates out of :meth:`run`."""
        return dict(self._failures)

    def request_drain(self, reason: str = "api") -> None:
        """Stop admitting queued work (idempotent): lanes in flight and
        preempted requests run to their end, then the queue fails into
        :meth:`failures`; :meth:`submit` refuses from now on."""
        if self._draining:
            return
        self._drain_reason = reason
        self._draining = True

    def drain(self, reason: str = "api") -> dict[int, np.ndarray]:
        """:meth:`request_drain`, then :meth:`run`: the completed results;
        everything that never started is in :meth:`failures`."""
        self.request_drain(reason)
        return self.run()

    def stats(self) -> dict:
        """Cumulative serving counters; keys keep the JAX server's names.
        The paged-pool keys are always present (zeros when slotted).
        ``lanes_busy_peak`` and ``kv_pool_occupancy_peak`` are this
        package's own: the most lanes that decoded in one round and the
        fullest the pool was at a dispatch; so are the ``decode_graph_*``
        keys: captures and replays of the decode chunk (both 0 on the CPU),
        the capture's seconds and its graph pool's bytes; and the
        ``delivered_lane_steps``, ``persistent_steps_executed`` and
        ``persistent_graph_*`` keys: the tokens persistent rounds
        delivered to live lanes, the steps they ran (delivered or past an
        exit), and the captures and replays of their graph. The
        scheduler's ``sched_*``, ``fused_*`` and persistent keys are the
        JAX server's, as are the prefix, copy-on-write and host-tier keys
        (zeros when the feature is off): ``prefix_hit_ratio`` is hits over
        this server's admitted lookups, ``kv_demotions`` and
        ``kv_prefetches`` count the tier's segment moves and the
        preemption spills and resumes a host tier accounts. So is
        ``kv_resume_staged``: the resumes that landed a staged upload. So
        are the occupancy keys (``tokens_per_round``, ``slots_busy``,
        ``queued``, ``batch_occupancy``, ``kv_slot_utilization``), the
        layout and the tensor-parallel keys (``kv_layout``,
        ``kv_pool_shards``, ``tp_degree``, ``tp_degraded``, ``tp_shrinks``,
        ``kv_pool_shard_occupancy``: one entry a shard, zeros at ``tp=1``
        and on slotted servers); ``kv_pool_shard_occupancy_peak`` is this
        package's own, each shard's fullest at a dispatch. ``arena_bytes``
        counts the one copy the shards share on this device."""
        pool, exe, rnd = self.kv_pool, self._decode, self._round
        store, host = self.prefix_store, self._kv_host
        tier = store if isinstance(store, PagedPrefixTier) else None
        lookups = self._prefix_hits + self._prefix_misses
        arena_bytes = cache_bytes(pool.arena if pool else self.arena)
        busy = [b for b in range(self.max_batch) if self._slot_req[b] is not None]
        decoded = self._emitted - self._prefills
        return {
            "rounds": self._rounds,
            "decode_steps": self._decode_steps,
            "prefills": self._prefills,
            "prefill_batches": self._batch_prefills,
            "tokens_emitted": self._emitted,
            "tokens_per_round": (round(decoded / self._rounds, 3)
                                 if self._rounds else 0.0),
            "slots_busy": len(busy),
            "queued": len(self._queue),
            "batch_occupancy": round(len(busy) / self.max_batch, 4),
            # Mean cache fill of the busy lanes: positions over max_len.
            "kv_slot_utilization": round(float(np.mean(
                [min(1.0, self._pos[b] / self.max_len) for b in busy])), 4)
            if busy else 0.0,
            "ttft_s": self._ttft.summary(),
            "decode_token_s": self._tok_lat.summary(),
            "arena_bytes": arena_bytes,
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
            "failed_requests": len(self._failures),
            "draining": self._draining,
            "decode_graph_captures": exe.captures,
            "decode_graph_replays": exe.replays,
            "decode_graph_capture_s": round(exe.capture_s, 6),
            "decode_graph_pool_bytes": exe.pool_bytes,
            **self._sched.stats(),
            "fused_enabled": int(self._fused_ok),
            "fused_admissions": self._fused_admissions,
            "persistent": int(self._persistent),
            "persistent_cap": self._persistent_cap,
            "persistent_rounds": self._persistent_rounds,
            "delivered_steps": self._last_delivered,
            "delivered_steps_total": self._delivered_total,
            "persistent_exits": dict(self._persistent_exits),
            "delivered_lane_steps": self._delivered_lane_steps,
            "persistent_steps_executed": rnd.executed_total if rnd else 0,
            "persistent_graph_captures": rnd.captures if rnd else 0,
            "persistent_graph_replays": rnd.replays if rnd else 0,
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "prefix_tokens_reused": self._prefix_tokens_reused,
            "prefix_hit_ratio": (round(self._prefix_hits / lookups, 4)
                                 if lookups else 0.0),
            "prefix_store_tokens": store.tokens_used if store else 0,
            "prefix_store_occupancy": store.occupancy() if store else 0.0,
            # The paged tier has no arena of its own: its footprint is the
            # share of the pool its segments' blocks hold.
            "prefix_store_bytes": (
                arena_bytes * tier.blocks_used // pool.num_blocks if tier
                else cache_bytes(store.arena) if store else 0),
            "cow_copies": self._cow_copies,
            "kv_host_tokens": host.capacity_tokens if host else 0,
            "kv_host_blocks": host.blocks_used if host else 0,
            "kv_demotions": self._host_demotions + (tier.demotions if tier else 0),
            "kv_prefetches": (self._host_prefetches
                              + (tier.prefetches if tier else 0)),
            "kv_resume_staged": self._resume_staged,
            "kv_layout": self._kv_layout,
            "kv_pool_shards": pool.shards if pool else 1,
            "tp_degree": self._tp,
            "tp_degraded": 0,  # no mesh shrink without fault detection
            "tp_shrinks": 0,
            "kv_pool_shard_occupancy": self._pool_shard_occupancy(),
            "kv_pool_shard_occupancy_peak": list(self._shard_peak),
        }

    def _pool_shard_occupancy(self) -> list:
        """Each shard's pool fill, ``tp`` entries: the sub-pools' own under
        the blocks layout, the pool's under heads (every block spans every
        shard), zeros at ``tp=1`` and on slotted servers."""
        if self._tp <= 1 or self.kv_pool is None:
            return [0.0] * self._tp
        if self.kv_pool.shards > 1:
            return self.kv_pool.shard_occupancy()
        return [self.kv_pool.occupancy()] * self._tp

    # ----- admission -------------------------------------------------------

    def _admit(self) -> None:
        """Refill free slots from the queue, FIFO (:meth:`_take`), one
        forward per group: prefix hits on one segment at one match length
        and padded suffix share a ``prefill_suffix``, the rest a
        ``prefill_batch`` per padded length; hits run first, as in the JAX
        server. Loops because a request can finish during its own prefill
        (eos or a 1-token budget) and free its slot again. Paged: preempted
        requests are older than anything queued and resume first. A
        chunked admission in progress goes first of all (head-of-line), and
        the policy may start one instead of a whole pass; at most one chunk
        runs per pass while it defers."""
        pass_chunks = 0
        while True:
            if self._partial is not None:
                # Started work: it advances through a drain too.
                done, pass_chunks = self._advance_partial(pass_chunks)
                if not done:
                    return
                continue
            if not (self._queue or self._preempted):
                return
            free = [b for b in range(self.max_batch) if self._slot_req[b] is None]
            if not free:
                return
            if self._preempted and (
                    not self._queue
                    or self._preempted[0].req.rid < self._queue[0].rid):
                if self._resume_one(free[0]):
                    continue
                if self._draining and len(free) == self.max_batch:
                    # Every lane is free and the pool still cannot hold
                    # the spill: it never can, so the drain fails it.
                    self._fail_preempted(f"drained mid-flight "
                                         f"({self._drain_reason}): cannot "
                                         "re-admit")
                    continue
                return  # strict FIFO: nothing admits past it
            if self._draining:
                return  # queued work never started: _finish_drain fails it
            directive = self._sched.directive(
                live_lanes=sum(r is not None for r in self._slot_req),
                pending_tokens=self._cold_cost(self._queue[0]))
            if not directive.admit:
                if not self._start_partial():
                    return  # paged reservation failed: head-of-line wait
                continue  # the partial branch runs this pass's chunk
            take = self._take(len(free))
            if not take:
                return
            hit_groups: dict[tuple, list] = {}
            groups: dict[int, list] = {}
            for req, hit in take:
                if hit is None:
                    groups.setdefault(self._cold_cost(req), []).append(req)
                    continue
                pad = self._suffix_pad(hit.length, len(req.prompt) - hit.length)
                hit_groups.setdefault((id(hit.segment), hit.length, pad),
                                      []).append((req, hit))
            it = iter(free)
            for (_seg, _m, pad_len), pairs in hit_groups.items():
                reqs, hits = zip(*pairs)
                self._fill_slots([next(it) for _ in reqs], list(reqs), pad_len,
                                 list(hits))
            for pad_len, reqs in groups.items():
                self._fill_slots([next(it) for _ in reqs], reqs, pad_len)

    def _take(self, n_free: int) -> list:
        """Pop one pass's admitted set: the FIFO prefix of the queue that
        fits ``n_free`` lanes and, paged, whose block reservations succeed;
        the first request the pool cannot hold stays at the head and ends
        the pass. Each lookup pins its hit, and a failed reservation undoes
        the lookup wholly. Returns ``[(request, hit or None)]``."""
        take = []
        while self._queue and len(take) < n_free:
            req = self._queue[0]
            hit = self._prefix_lookup_raw(req)
            if self.paged and not self._reserve_lane_blocks(req, hit):
                if self.prefix_store is not None:
                    self.prefix_store.unlookup(hit)
                break
            self._count_prefix(hit)
            self._queue.popleft()
            self._sched.note_queue_delay(time.perf_counter() - req.t_submit)
            take.append((req, hit))
        return take

    # ----- prefix cache ----------------------------------------------------

    def _prefix_lookup_raw(self, req: _Request) -> Optional[PrefixHit]:
        """The store's lookup without the server's counters (a paged
        reservation may still undo it), pinned; None when the store is off
        or nothing usable is cached. A hit whose suffix fits no bucket
        inside ``max_len`` while the whole prompt fits one is cancelled:
        cold bucketed admission keeps the bounded shapes."""
        if self.prefix_store is None:
            return None
        hit = self.prefix_store.lookup(req.prompt)
        if hit is not None:
            n = len(req.prompt)
            if (self._suffix_bucket(hit.length, n - hit.length) is None
                    and any(k >= n for k in self.prefill_buckets)):
                self.prefix_store.cancel(hit)
                hit = None
        return hit

    def _count_prefix(self, hit: Optional[PrefixHit]) -> None:
        """The server's counters for one admitted lookup (none when the
        store is off)."""
        if self.prefix_store is None:
            return
        if hit is None:
            self._prefix_misses += 1
            return
        self._prefix_hits += 1
        self._prefix_tokens_reused += hit.length

    def _suffix_bucket(self, m: int, s_len: int) -> Optional[int]:
        """The smallest bucket that holds a suffix of ``s_len`` after a match
        of ``m`` inside ``max_len``, or None."""
        return next((k for k in self.prefill_buckets
                     if k >= s_len and m + k <= self.max_len), None)

    def _suffix_pad(self, m: int, s_len: int) -> int:
        """The padded suffix length of a hit at ``m``: its
        :meth:`_suffix_bucket`, or the exact length when none fits."""
        pad = self._suffix_bucket(m, s_len)
        return pad if pad is not None else s_len

    def _commit(self, slots: list[int], reqs: list, caches) -> None:
        """Write one admission forward's cache rows to their lanes (slotted
        arena or reserved pool blocks), then insert each prompt into the
        prefix cache."""
        if not self.paged:
            _write_slots(self.arena, caches, torch.as_tensor(
                slots, dtype=torch.long, device=self.device))
        elif len(reqs) == 1:
            self._paged_commit(slots[0], reqs[0], caches, 0)
        else:
            self._paged_commit_batch(slots, reqs, caches)
        if self.prefix_store is not None:
            for i, req in enumerate(reqs):
                self.prefix_store.insert(req.prompt, caches, i)

    def _fill_slots(self, slots: list[int], reqs: list, pad_len: int,
                    hits: Optional[list] = None) -> None:
        """Admit N requests in one ``[N, pad_len]`` forward and write their
        caches to the lanes. Cold (``hits`` None): a ``prefill_batch`` of
        the bucket-padded prompts. Prefix hits on one segment at one match
        length ``m``: the prefix rows copied into fresh caches (one copy
        fanned out to N rows) and a ``prefill_suffix`` of the padded rest
        at offset ``m`` (plain attention over the cache, the JAX rule).
        Each prompt is then inserted into the prefix cache, which for a hit
        deepens the store where the prompt reaches a bucket past the
        match."""
        n = len(reqs)
        m = hits[0].length if hits else 0
        tokens = np.zeros((n, pad_len), np.int32)
        true_lens = np.array([len(r.prompt) - m for r in reqs], np.int32)
        for i, req in enumerate(reqs):
            tokens[i, : true_lens[i]] = req.prompt[m:]
        t0 = time.perf_counter()
        tokens = torch.from_numpy(tokens).to(self.device)
        if hits:
            caches = self.prefix_store.materialize(hits[0], self.max_len, n=n)
            _c, last_logits, _pos = prefill_suffix(
                self.params, tokens, self.cfg, caches, m, return_logits=True,
                true_len=torch.from_numpy(true_lens).to(self.device))
        else:
            caches, last_logits, _pos = prefill_batch(
                self.params, tokens, self.cfg, pad_len,
                torch.from_numpy(true_lens), kv_quantized=self.kv_quant)
        firsts = _next_token(last_logits, self.generator, self._do_sample,
                             self._temp_dev, self.top_k, self.top_p).cpu().numpy()
        t_first = time.perf_counter()  # the transfer above fenced the forward
        self._sched.note_prefill(n * pad_len, t_first - t0)
        self._commit(slots, reqs, caches)
        if n >= 2:
            self._batch_prefills += 1
        for i, (b, req) in enumerate(zip(slots, reqs)):
            self._finish_admission(b, req, int(firsts[i]), m + int(true_lens[i]),
                                   t_first, hit=hits[i] if hits else None)

    def _finish_admission(self, b: int, req: _Request, first: int, pos: int,
                          t_first: float,
                          hit: Optional[PrefixHit] = None) -> None:
        req.out.append(first)
        self._prefills += 1
        self._emitted += 1
        self._ttft.observe(t_first - req.t_submit)
        self._slot_req[b] = req
        self._slot_prefix[b] = hit  # pinned until the request finishes
        self._pos[b] = pos
        self._last[b] = first
        self._fresh_rows.add(b)  # overlap: override the in-flight row
        self._maybe_finish(b, [first])

    # ----- chunked admission -----------------------------------------------

    def _cold_cost(self, req: _Request) -> int:
        """The padded prefill tokens a whole admission of ``req`` runs: the
        policy's projection input."""
        n = len(req.prompt)
        return next((k for k in self.prefill_buckets if k >= n), None) or n

    def _start_partial(self) -> bool:
        """Begin a chunked admission of the queue head: look it up and
        reserve its blocks (paged) as a whole admission would, then park it
        as the partial with caches of its own, a hit's prefix rows already
        in them; :meth:`_advance_partial` runs its chunks from there. False
        when the pool cannot hold it: it stays queued."""
        take = self._take(1)
        if not take:
            return False
        req, hit = take[0]
        if hit is not None:
            caches = self.prefix_store.materialize(hit, self.max_len)
        else:
            caches = init_kv_caches(self.cfg, 1, self.max_len,
                                    device=self.device, quantized=self.kv_quant)
        self._partial = _PartialPrefill(req=req, hit=hit, caches=caches,
                                        offset=hit.length if hit else 0)
        return True

    def _advance_partial(self, ran: int = 0) -> tuple[bool, int]:
        """Advance the chunked admission. While the policy defers it runs
        at most one chunk a pass (``ran`` counts the chunks this pass has
        run already), or, fused, arms the next decode dispatch to carry
        the chunk; once the policy admits it runs the rest. Returns
        ``(landed in a lane, ran)``."""
        self._fuse_pending = False  # decided afresh every pass
        while True:
            p = self._partial
            remaining = len(p.req.prompt) - p.offset
            if remaining <= 0:
                return False, ran  # the final slice rides a dispatch in flight
            live = sum(r is not None for r in self._slot_req)
            d = self._sched.directive(live_lanes=live, pending_tokens=remaining,
                                      partial=True)
            if not d.admit:
                if d.fused and self._fused_ok and live > 0:
                    self._fuse_pending = True
                    self._sched.defers += 1
                    return False, ran
                if ran:
                    return False, ran  # one chunk per decode dispatch
                self._sched.defers += 1
            done = self._prefill_one_chunk(p)
            ran += 1
            if done:
                return True, ran

    def _slice_geometry(self, p: _PartialPrefill) -> tuple:
        """The slice rule both chunk paths share: ``chunk_tokens`` wide,
        right-padded, exact width where padding would pass ``max_len``.
        Returns ``(suffix, take, width)``."""
        n = len(p.req.prompt)
        c = self._sched.chunk_tokens
        take = min(c, n - p.offset)
        width = c if p.offset + c <= self.max_len else take
        suffix = np.zeros(width, np.int32)
        suffix[:take] = p.req.prompt[p.offset:p.offset + take]
        return suffix, take, width

    def _run_slice(self, p: _PartialPrefill, suffix: np.ndarray, offset: int,
                   take: int) -> torch.Tensor:
        """One ``prefill_suffix`` slice into the partial's caches, in
        place: the slice's last-position logits ``[1, vocab]``."""
        tokens = self._host_tensor(suffix[None, :], torch.int64).to(
            self.device, non_blocking=True)
        _caches, logits, _pos = prefill_suffix(
            self.params, tokens, self.cfg, p.caches, offset,
            return_logits=True, true_len=take)
        return logits

    def _prefill_one_chunk(self, p: _PartialPrefill) -> bool:
        """Run one slice of the chunked admission now, fenced (the pass's
        budget is wall time); the final slice samples the first token and
        lands the admission. True when it landed."""
        suffix, take, width = self._slice_geometry(p)
        last = p.offset + take >= len(p.req.prompt)
        t0 = time.perf_counter()
        logits = self._run_slice(p, suffix, p.offset, take)
        first = None
        if last:
            first = int(self._sample_first(logits))
        elif self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t_done = time.perf_counter()
        p.offset += take
        self._sched.chunks += 1
        self._sched.note_prefill(width, t_done - t0)
        if last:
            self._commit_partial(p, first, t_done)
        return last

    def _sample_first(self, logits: torch.Tensor) -> int:
        return int(_next_token(logits, self.generator, self._do_sample,
                               self._temp_dev, self.top_k, self.top_p)[0])

    def _commit_partial(self, p: _PartialPrefill, first: int,
                        t_first: float) -> None:
        """Land a finished chunked admission in a free lane (free by
        construction: one was free when it started, and nothing fills
        lanes while it is head-of-line), the same way for the inline and
        the fused final slice."""
        req = p.req
        b = next(i for i in range(self.max_batch) if self._slot_req[i] is None)
        self._commit([b], [req], p.caches)
        self._partial = None
        if p.fused:
            self._fused_admissions += 1
        self._finish_admission(b, req, first, len(req.prompt), t_first,
                               hit=p.hit)

    def _prepare_fused_chunk(self) -> Optional[tuple]:
        """Take the pending slice for a fused dispatch, advancing the
        partial's offset and counters at dispatch. Returns ``(suffix,
        offset, take, is_last)``, or None when none is pending."""
        if not (self._fuse_pending and self._fused_ok
                and self._partial is not None):
            self._fuse_pending = False
            return None
        self._fuse_pending = False
        p = self._partial
        n = len(p.req.prompt)
        if p.offset >= n:
            return None  # the final slice is already in flight
        suffix, take, _width = self._slice_geometry(p)
        offset = p.offset
        p.offset += take
        p.fused += 1
        self._sched.chunks += 1
        return suffix, offset, take, p.offset >= n

    def _apply_fused(self, fc: Optional[_FusedChunk]) -> None:
        """Land a slice that rode a decode dispatch, at its retire: only
        the final slice has work left, sampling the first token from the
        slice's logits and committing the admission."""
        if fc is None or not fc.last or self._partial is not fc.partial:
            return
        first = self._sample_first(fc.logits)
        self._commit_partial(fc.partial, first, time.perf_counter())

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
            self._release_prefix(b)
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
        """Drop the lane's block references: private blocks return to the
        pool now, tier-shared ones once the tier and every other lane let
        go."""
        self.kv_pool.unref(self._lane_blocks[b])
        self._set_lane_table(b, [])

    def _release_prefix(self, b: int) -> None:
        """Unpin the lane's prefix hit: its segment may be evicted again
        once no other request holds it."""
        hit, self._slot_prefix[b] = self._slot_prefix[b], None
        if hit is not None:
            self.prefix_store.release(hit)

    def _alloc_blocks(self, n: int) -> Optional[list]:
        """``n`` pool blocks, evicting (or, with a host tier, demoting)
        unpinned prefix-tier segments LRU first under pressure; None when
        live state holds everything. Every allocation for a lane comes
        through here, so the tier always gives way before a preemption."""
        got = self.kv_pool.try_alloc(n)
        while got is None:
            tier = self.prefix_store
            if not isinstance(tier, PagedPrefixTier) or not tier.evict_one():
                return None
            got = self.kv_pool.try_alloc(n)
        return got

    def _reserve_lane_blocks(self, req: _Request,
                             hit: Optional[PrefixHit] = None) -> bool:
        """Reserve the blocks ``req``'s admission scatter needs, those of
        its bucket-padded rows, BEFORE its prefill forward runs: a failed
        reservation must leave the request queued, not waste a forward. A
        hit shares the tier segment's fully covered blocks and gets private
        ones for the rest, the copy-on-write boundary block among them when
        the match is not block-aligned. The plan waits in ``_plans`` until
        the fill path commits it."""
        n = len(req.prompt)
        shared: list = []
        if hit is not None:
            rows = hit.length + self._suffix_pad(hit.length, n - hit.length)
            shared = self.prefix_store.shared_blocks(hit)
        else:
            rows = self._cold_cost(req)
        priv = self._alloc_blocks(-(-rows // self.kv_block) - len(shared))
        if priv is None:
            return False
        self.kv_pool.ref(shared)
        if hit is not None and hit.length % self.kv_block:
            self._cow_copies += 1
        self._plans[req.rid] = _LanePlan(shared + priv, len(shared))
        return True

    def _paged_commit(self, b: int, req: _Request, caches, row: int) -> None:
        """Land one admission's cache row in its reserved private blocks and
        install the lane table. Shared tier blocks are masked with SCRATCH
        in the scatter: other lanes read their rows, which must not be
        written again."""
        plan = self._plans.pop(req.rid)
        scatter = [SCRATCH_BLOCK] * plan.n_shared + plan.table[plan.n_shared:]
        pool_write_seq(self.kv_pool.arena, caches, row,
                       table_tensor(scatter, self.device), self.kv_block)
        self._set_lane_table(b, plan.table)

    def _paged_commit_batch(self, slots: list[int], reqs: list, caches) -> None:
        """Batched :meth:`_paged_commit`: one scatter per leaf for a whole
        admission group, shared entries masked with SCRATCH per row and
        tables padded with SCRATCH to the widest plan; masked and pad
        entries collide only on SCRATCH, which nothing reads, and never
        touch the ZERO block."""
        plans = [self._plans.pop(req.rid) for req in reqs]
        width = max(len(p.table) for p in plans)
        tables = np.full((len(plans), width), SCRATCH_BLOCK, np.int32)
        for i, plan in enumerate(plans):
            tables[i, plan.n_shared:len(plan.table)] = plan.table[plan.n_shared:]
        pool_write_batch(self.kv_pool.arena, caches,
                         table_tensor(tables, self.device), self.kv_block)
        for b, plan in zip(slots, plans):
            self._set_lane_table(b, plan.table)

    def _preempt_lane(self, b: int) -> None:
        """Preempt the request in lane ``b`` under pool pressure: gather its
        written KV rows out of the pool, copy them to the host, release its
        blocks and prefix pin and put it on the wait list. Only the blocks
        that hold written rows (``ceil(pos / bs)``) are spilled: there is no
        compiled executable whose shape a full-width table would keep
        fixed. Greedy output is unchanged: :meth:`_resume_one` re-lands the
        rows verbatim and decode resumes at the same ``pos`` with the same
        ``last``. Under overlap those are the host's, one chunk behind the
        device: the in-flight chunk's tokens for this lane are dropped at
        retire. The gather and the copy to pinned memory are queued on the
        stream behind that chunk, which still writes these blocks, so they
        read its rows; what it writes past ``pos`` into the freed blocks
        lands, in stream order, before anything their next owner writes.
        With a host tier the spill is accounted there, pinned."""
        req = self._slot_req[b]
        pos = int(self._pos[b])
        written = self._lane_blocks[b][: -(-pos // self.kv_block)]
        spilled = rows_to_host(pool_gather_rows(
            self.kv_pool.arena, table_tensor(written, self.device), self.kv_block))
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._free_lane(b)
        self._release_prefix(b)
        # Kept sorted by rid: a pass preempts youngest first while older
        # requests may already wait, and resume order must be submit order.
        self._preempted = deque(sorted(
            [*self._preempted,
             _Preempted(req=req, kv=spilled, pos=pos, last=int(self._last[b]),
                        ready=ready)],
            key=lambda p: p.req.rid))
        self._slot_req[b] = None
        self._preemptions += 1
        if self._kv_host is not None:
            self._kv_host.put(("spill", req.rid), pos, pinned=True)
            self._host_demotions += 1

    def _resume_one(self, b: int) -> bool:
        """Re-admit the OLDEST preempted request into lane ``b``: fresh
        blocks for its spilled rows, the rows re-landed as they were (int8
        payload and scale alike), decode resuming where the spill cut it.
        False when the pool still cannot hold it: the caller waits."""
        pre = self._preempted[0]
        blocks = self._alloc_blocks(-(-pre.pos // self.kv_block))
        if blocks is None:
            return False
        stage, self._stage = self._stage, None
        if stage is not None and stage.done is not None:
            # Held, source and rows, until its upload is known complete.
            self._h2d_inflight.append(stage)
        if stage is not None and stage.rid == pre.req.rid:
            rows = stage.rows
            if stage.done is not None:
                # The main stream waits for the side stream's upload and
                # uses the rows it made.
                main = torch.cuda.current_stream(self.device)
                main.wait_event(stage.done)
                for t in cache_leaves(rows):
                    t.record_stream(main)
            self._resume_staged += 1
        else:
            rows = rows_to_device(pre.kv, self.device)
        pool_scatter_rows(self.kv_pool.arena, rows,
                          table_tensor(blocks, self.device), self.kv_block)
        self._set_lane_table(b, blocks)
        self._slot_req[b] = pre.req
        self._pos[b] = pre.pos
        self._last[b] = pre.last
        self._fresh_rows.add(b)  # overlap: override the in-flight row
        self._preempted.popleft()
        if self._kv_host is not None:
            self._kv_host.pop(("spill", pre.req.rid))
            self._host_prefetches += 1
        return True

    def _stage_resume_prefetch(self) -> None:
        """Start the upload of the oldest preempted request's spilled rows
        while a decode chunk is in flight (called right after each
        dispatch, and after a lock-step round), so that its resume lands
        rows already on the card. Only with a host tier, one staged upload
        at a time. On CUDA the upload runs on a side stream from the pinned
        spill, after the spill's own copy (its ``ready`` event), beside the
        chunk; it records ``done``, which the resume waits for. A failed
        copy raises."""
        if self._kv_host is None or not self._preempted:
            return
        pre = self._preempted[0]
        if self._stage is not None and self._stage.rid == pre.req.rid:
            return  # already staged for the current head
        if self.device.type != "cuda":
            self._stage = _ResumeStage(pre.req.rid, rows_to_device(pre.kv,
                                                                   self.device))
            return
        self._h2d_inflight = [s for s in self._h2d_inflight
                              if not s.done.query()]
        if self._h2d_stream is None:
            self._h2d_stream = torch.cuda.Stream(self.device)
        side = self._h2d_stream
        side.wait_event(pre.ready)
        with torch.cuda.stream(side):
            rows = rows_to_device(pre.kv, self.device)
            done = torch.cuda.Event()
            done.record(side)
        if self._stage is not None:  # staged for an earlier head: dropped
            self._h2d_inflight.append(self._stage)
        self._stage = _ResumeStage(pre.req.rid, rows, done, src=pre.kv)

    def _ensure_blocks(self) -> None:
        """Grow every live lane's table to cover the next dispatch window,
        OLDEST request first: ``chunk × decode_steps`` positions past the
        host's ``pos``, twice that under overlap, whose host ``pos`` lags
        the device by the chunk in flight; a persistent server's whole step
        cap, since a round cannot ask the host for blocks midway. When the
        pool is exhausted the YOUNGEST live lane is preempted until the
        older ones fit; the head of the line always makes progress because
        the drained pool holds one full-length request. Growth is capped by
        the request's own ``prompt + max_new_tokens`` and the table width:
        writes past a finished request's budget aim at SCRATCH, so no block
        is spent on dead rows."""
        if not self.paged:
            return
        bs = self.kv_block
        lookahead = (self._persistent_cap if self._persistent
                     else self._dispatch_steps * (2 if self.overlap else 1))
        lanes = sorted((b for b in range(self.max_batch)
                        if self._slot_req[b] is not None),
                       key=lambda b: self._slot_req[b].rid)
        for b in lanes:
            req = self._slot_req[b]
            if req is None:
                continue  # preempted while an older lane grew
            cap = -(-(len(req.prompt) + req.max_new_tokens) // bs)
            need = min(-(-(int(self._pos[b]) + lookahead) // bs), cap,
                       self._nb_max)
            while len(self._lane_blocks[b]) < need and self._slot_req[b] is req:
                got = self._alloc_blocks(need - len(self._lane_blocks[b]))
                if got is not None:
                    self._set_lane_table(b, self._lane_blocks[b] + got)
                    break
                self._preempt_lane(max(
                    (v for v in range(self.max_batch)
                     if self._slot_req[v] is not None),
                    key=lambda v: self._slot_req[v].rid))

    # ----- the round loop --------------------------------------------------

    def step(self) -> bool:
        """One round of the server's loop: :meth:`_step_overlapped` by
        default, :meth:`_step_lockstep` with ``overlap=False``. A requested
        drain finishes here once nothing is in flight. Returns False when
        the queue, the wait list, the lanes and the pipeline are empty."""
        # Persistent rounds run lock-step: the host reads the delivered
        # count at the fence before it can schedule the next round.
        alive = (self._step_overlapped() if self.overlap and not self._persistent
                 else self._step_lockstep())
        if self._draining and not self._drain_done and self._drain_idle():
            self._finish_drain()
            alive = False
        return alive

    def _drain_idle(self) -> bool:
        """Nothing in flight: no chunk, no busy lane, no chunked admission,
        no preempted spill (spills are started work; the next admission
        resumes them)."""
        return (self._inflight is None and not self._preempted
                and self._partial is None
                and all(r is None for r in self._slot_req))

    def _finish_drain(self) -> None:
        """Fail everything that never started, with the JAX server's
        messages. Every submitted request is now in the results or in
        :meth:`failures`."""
        while self._preempted:
            self._fail_preempted(f"drained mid-flight ({self._drain_reason})")
        while self._queue:
            req = self._queue.popleft()
            self._failures[req.rid] = (
                f"drained before start ({self._drain_reason})")
        self._drain_done = True

    def _fail_preempted(self, error: str) -> None:
        """Fail the oldest preempted request, its host-tier accounting
        released with it."""
        pre = self._preempted.popleft()
        self._failures[pre.req.rid] = error
        if self._kv_host is not None:
            self._kv_host.pop(("spill", pre.req.rid))

    def _decode_budget(self) -> Optional[np.ndarray]:
        """Per-lane upper bounds on the tokens still to come, which arm the
        freeze mask at ``decode_steps > 1`` (None at K = 1: the plain
        chunk). From the host's retired counts: under overlap they exceed
        the truth by at most the chunk in flight, so a lane freezes late
        (tokens trimmed), never early. Empty lanes get 0. Persistent
        servers always arm it: the round's exits read it."""
        if self._decode_steps <= 1 and not self._persistent:
            return None
        budget = np.zeros(self.max_batch, np.int32)
        for b, req in enumerate(self._slot_req):
            if req is not None:
                budget[b] = max(0, req.max_new_tokens - len(req.out))
        return budget

    def _host_tensor(self, arr, dtype=torch.int32) -> torch.Tensor:
        """A snapshot of host array ``arr`` for one dispatch, pinned on
        CUDA: its copy to the card runs asynchronously, and later edits of
        ``arr`` cannot reach it."""
        t = torch.empty(np.shape(arr), dtype=dtype,
                        pin_memory=self.device.type == "cuda")
        t.numpy()[...] = arr
        return t

    def _to_device(self, arr, dtype=torch.int32) -> torch.Tensor:
        return self._host_tensor(arr, dtype).to(self.device, non_blocking=True)

    def _dispatch_decode(self, tok, pos):
        """The one decode dispatch: one chunk of ``chunk × decode_steps``
        steps for every lane from ``tok``/``pos`` (device tensors, or host
        snapshots), with the budget mask and (paged) a snapshot of the
        block tables; an admission slice rides along when one is pending
        under the fused plan (its logits wait in ``_fused_ret``), and a
        persistent server runs a persistent round otherwise (its delivered
        count and windows wait in ``_persistent_fut``). Lanes past their
        budget decode on harmlessly: their writes clamp inside their own
        slot or land in the scratch block, and their extra tokens are
        trimmed. Returns ``(toks, last, pos)`` on the device, not yet
        waited for, except a persistent round's, which has finished."""
        budget = self._decode_budget()
        kw = {}
        if budget is not None:
            kw["budget"] = self._host_tensor(budget)
        if self.paged:
            self._occupancy_peak = max(self._occupancy_peak,
                                       self.kv_pool.occupancy())
            self._shard_peak = [max(a, b) for a, b in zip(
                self._shard_peak, self._pool_shard_occupancy())]
            kw["block_tables"] = self._host_tensor(self._bt_host)
        fuse = self._prepare_fused_chunk()
        if fuse is not None:
            p = self._partial
            suffix, offset, take, is_last = fuse
            out, logits = self._decode.fused(
                lambda: self._run_slice(p, suffix, offset, take), tok, pos, **kw)
            self._fused_ret = _FusedChunk(partial=p, last=is_last, logits=logits)
            return out
        if self._persistent:
            window = self._persistent_window()
            toks, last, new_pos, delivered = self._round(
                tok, pos, kw["budget"], self._host_tensor(window),
                kw.get("block_tables"))
            self._persistent_fut = (delivered, window)
            return toks[:, :delivered], last, new_pos
        return self._decode(tok, pos, **kw)

    def _persistent_window(self) -> np.ndarray:
        """Each lane's write bound for a persistent round: the end of its
        reserved blocks when paged, the arena's length when slotted."""
        window = np.full(self.max_batch, self.max_len, np.int32)
        if self.paged:
            for b in range(self.max_batch):
                if self._slot_req[b] is not None:
                    window[b] = min(len(self._lane_blocks[b]) * self.kv_block,
                                    self.max_len)
        return window

    def _step_lockstep(self) -> bool:
        """Refill free lanes, (paged) grow the lanes' tables or preempt,
        then one dispatch for every lane, fenced by its token transfer. A
        persistent round is accounted by the steps it delivered, and its
        exit attributed: ``cap`` when it delivered the cap, ``window``
        when a lane still running sits at its window edge, else
        ``done``."""
        self._admit()
        self._ensure_blocks()
        self._fresh_rows.clear()  # lock-step dispatch reads host rows
        active = [b for b in range(self.max_batch) if self._slot_req[b] is not None]
        if not active:
            return (bool(self._queue) or bool(self._preempted)
                    or self._partial is not None)
        self._lanes_peak = max(self._lanes_peak, len(active))
        t0 = time.perf_counter()
        toks, last, pos = self._dispatch_decode(self._host_tensor(self._last),
                                                self._host_tensor(self._pos))
        host = DeviceFence(toks=toks, last=last, pos=pos).wait()
        dur = time.perf_counter() - t0
        fut, self._persistent_fut = self._persistent_fut, None
        delivered = None if fut is None else fut[0]
        steps = self._dispatch_steps if delivered is None else delivered
        self._tok_lat.observe(dur / max(steps, 1))
        self._sched.note_round(dur, steps=max(steps, 1))
        self._last, self._pos = host["last"], host["pos"]
        self._rounds += 1
        for b in active:
            new = host["toks"][b].tolist()
            self._slot_req[b].out.extend(new)
            self._emitted += len(new)
            self._maybe_finish(b, new)
        if fut is not None:
            window = fut[1]
            if delivered >= self._persistent_cap:
                reason = "cap"
            elif any(self._slot_req[b] is not None and self._pos[b] >= window[b]
                     for b in active):
                reason = "window"
            else:
                reason = "done"
            self._persistent_rounds += 1
            self._delivered_lane_steps += delivered * len(active)
            self._last_delivered = delivered
            self._delivered_total += delivered
            self._persistent_exits[reason] += 1
        # A slice that rode this dispatch lands after the decode tokens.
        fc, self._fused_ret = self._fused_ret, None
        self._apply_fused(fc)
        # No chunk is in flight here, but the upload still runs ahead of
        # the next round's admission pass.
        self._stage_resume_prefetch()
        return True

    def _step_overlapped(self) -> bool:
        """One pipelined round: dispatch the NEXT chunk first, from the
        in-flight chunk's ``last``/``pos`` on the device with refilled rows
        merged in, and only then retire the in-flight chunk, so that finish
        detection and admission run while the card computes. A chunk
        dispatched before its predecessor's tokens were read may decode
        rows of requests that turn out to have finished: retire drops those
        tokens (wasted work on a dead row, never a wrong token)."""
        prev, self._inflight = self._inflight, None
        if prev is None:
            self._admit()  # pipeline empty: admission feeds this dispatch
        busy = any(r is not None for r in self._slot_req)
        if busy and (prev is None or self._any_survives(prev)):
            self._ensure_blocks()  # paged: before the tables are copied
            if prev is None:
                last = self._host_tensor(self._last)
                pos = self._host_tensor(self._pos)
            elif self._fresh_rows:
                mask = np.zeros(self.max_batch, np.bool_)
                mask[list(self._fresh_rows)] = True
                fresh = self._to_device(mask, torch.bool)
                last = _merge_rows(prev.last, self._to_device(self._last), fresh)
                pos = _merge_rows(prev.pos, self._to_device(self._pos), fresh)
            else:
                last, pos = prev.last, prev.pos
            self._fresh_rows.clear()
            self._dispatch_chunk(last, pos)
            self._stage_resume_prefetch()  # overlaps the chunk just dispatched
        if prev is not None:
            self._retire(prev)  # host work overlaps the dispatched chunk
        return (self._inflight is not None or bool(self._queue)
                or bool(self._preempted) or self._partial is not None
                or any(r is not None for r in self._slot_req))

    def _any_survives(self, prev: _Inflight) -> bool:
        """Whether any lane is certain to still be decoding once the
        in-flight chunk lands: a lane at ``len(out) + steps >=
        max_new_tokens`` is certain to finish (eos only finishes it
        earlier). When none survives, the next chunk would be wholly dead
        (budgets aligned to chunk edges would waste half the card), so the
        pipeline drains and the next round dispatches from host state."""
        prev_req = dict(prev.slots)
        for b, req in enumerate(self._slot_req):
            if req is None:
                continue
            if prev_req.get(b) is not req:
                return True  # refilled since dispatch: untouched budget
            if len(req.out) + self._dispatch_steps < req.max_new_tokens:
                return True
        return False

    def _dispatch_chunk(self, last, pos) -> None:
        """Dispatch one chunk without waiting: a :class:`DeviceFence`
        starts its outputs' copy to the host behind it, before the next
        chunk can overwrite them."""
        active = [(b, req) for b, req in enumerate(self._slot_req)
                  if req is not None]
        self._lanes_peak = max(self._lanes_peak, len(active))
        toks, new_last, new_pos = self._dispatch_decode(last, pos)
        # A slice dispatched with the chunk rides its record to retire.
        fc, self._fused_ret = self._fused_ret, None
        self._inflight = _Inflight(
            fence=DeviceFence(toks=toks, last=new_last, pos=new_pos),
            last=new_last, pos=new_pos, slots=active,
            t_dispatch=time.perf_counter(), fused=fc)

    def _retire(self, fl: _Inflight) -> None:
        """Land one in-flight chunk: wait for its copy, hand its tokens to
        the requests that still own their lanes, land an admission slice
        that rode along, then refill freed lanes
        (their rows join the next dispatch through ``_fresh_rows``). ITL is
        the retire-to-retire cadence over the dispatch's steps, anchored at
        this chunk's dispatch when the pipeline was empty."""
        host = fl.fence.wait()
        now = time.perf_counter()
        round_s = now - max(fl.t_dispatch, self._t_last_retire)
        self._t_last_retire = now
        self._tok_lat.observe(round_s / self._dispatch_steps)
        # The retire cadence is the latency the policy steers by: an
        # admission that took host time between retires shows here.
        self._sched.note_round(round_s)
        self._rounds += 1
        for b, req in fl.slots:
            if self._slot_req[b] is not req:
                continue  # finished, refilled or preempted meanwhile
            self._last[b] = host["last"][b]
            self._pos[b] = host["pos"][b]
            new = host["toks"][b].tolist()
            req.out.extend(new)
            self._emitted += len(new)
            self._maybe_finish(b, new)
        # A slice that rode this chunk lands before the admission pass, so
        # a finished chunked admission unblocks the queue head in it.
        self._apply_fused(fl.fused)
        self._admit()


def serve_batch(params: Any, cfg: DecoderConfig, prompts: list,
                max_new_tokens: int = 64, **server_kwargs) -> list[np.ndarray]:
    """Continuous-batch a list of ragged prompts through a
    :class:`GenerationServer` built with ``server_kwargs`` (the overlapped
    loop unless they say ``overlap=False``); tokens in input order."""
    srv = GenerationServer(params, cfg, **server_kwargs)
    rids = [srv.submit(p, max_new_tokens) for p in prompts]
    results = srv.run()
    return [results[r] for r in rids]
